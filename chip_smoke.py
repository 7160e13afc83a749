#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device and build: CUDA and sm_90 present; the card's name and power
     limit; every hand-written kernel built from ``param_tpu_torch/kernels/
     csrc`` (one nvcc per source, in parallel).
  2. K1 (embedding bag) against its plain PyTorch version on the card: the
     1M x 128 f32 headline shape (B 8192, nnz 30, indices shifted per
     iteration), the DLRM trainer's shape (flat 8 x 100k x 64 table, 2048 x 8
     bags of 10) in f32 and bf16.
  3. K2 (sparse row update) against its plain version, SGD and Adagrad, on
     the trainer's flat 800k x 64 table with the deduplicated rows of one
     batch (163840 slots, the unused tail dropped as ids >= R).
  4. Timings: kernel, plain version, one library call computing the same
     function, and the least time the card could take.
  5. Model parity: a small DLRM's logits and one step of each sparse
     optimizer on the card (kernels) against the same on the CPU (plain
     versions).
  6. The DLRM trainer at the CLI's full default width through
     ``param_tpu_torch.cli.dlrm.main`` for 5 batches each of sparse_adagrad,
     sparse_sgd and dense adagrad, with the launch counts reset just before
     and read just after: K1 and K2 must have launched.
  7. K3 (tiled GEMM) against its plain version (f32 torch.matmul of the
     same inputs, TF32 off) in bf16 and f32 at GEMM_A / GEMM_C shapes and a
     ragged (100, 100, 100); library call torch.matmul in the same dtype.
  8. K4 (weight-resident GEMMs): S = 8 x (128, 4096, 4096) bf16; library
     call torch.matmul on the stacked A.
  9. K5 (int4 GEMM): llama2-7B MLP projections (M, 4096) @ (4096, 11008)
     and (M, 11008) @ (11008, 4096), g = 128, at M = 1, 8, 32, and MLP_A's
     (512, 4096) @ (4096, 4096).  No library call computes this function;
     torch.matmul on the dequantized bf16 weight is timed beside it as a
     different function.
 10. The compute-tier CLIs in-process at full width, the launch counts
     reset before each command and read after it: ``cli.compute gemm``
     (GEMM_A bf16 through K3; GEMM_C --compare; --weight-resident 8 through
     K4), ``emb --dataset baseline`` (K1), ``linear``, and
     ``cli.inference --dtype int4`` (K5, 18 layers; beside it the int8 and
     bf16 rungs, and int4 / int8 at batch 1); one int4 forward
     launches K5 exactly 18 times, and a small int4 MLP on the card agrees
     with the CPU plain path.
Timings (phases 2-4, 7-9) use CUDA events after a warm-up and report the
median of several windows with the spread (min-max): the kernel and the
library call replayed from a CUDA graph (the card's time, without the
host's cost of issuing the calls; the kernel is also timed issued eagerly
from Python), the plain version issued eagerly.  Bounds: bytes over
3.35 TB/s, or operations over the H100's peak for the type (989 TF/s bf16,
67 TF/s f32).
Then a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.
``--out PATH`` also writes the full results as JSON to PATH.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main(out_path=None) -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import param_tpu_torch  # noqa: F401
    except ImportError:
        fail(f"param_tpu_torch is not beside {__file__}: run from a checkout")

    import torch.nn.functional as F

    from param_tpu_torch import kernels
    from param_tpu_torch.kernels import build
    from param_tpu_torch.kernels.emb_gather import (
        emb_gather_cuda, emb_gather_plain,
    )
    from param_tpu_torch.kernels.sparse_update import (
        sparse_update_cuda, sparse_update_plain,
    )
    from param_tpu_torch.ops.sparse_update import dedup_row_updates
    from param_tpu_torch.utils.chip import bound_ms
    from param_tpu_torch.utils.device import require_sm90, resolve_device
    from param_tpu_torch.utils.timer import time_samples

    dev = resolve_device("cuda")
    require_sm90(dev)
    result = {"phases": {}}
    REPS = 5

    def timed(fn, iters, graph=True):
        """Median and spread (ms) over REPS windows of ``iters`` calls."""
        t = time_samples(fn, iters, reps=REPS, graph=graph)
        return dict(ms=statistics.median(t), min=min(t), max=max(t))

    def fmt(t):
        return f"{t['ms']:.4f} ms ({t['min']:.4f}-{t['max']:.4f})"

    def timings(kernel, plain, library, iters):
        """Kernel (graph and eager), plain (eager) and library (graph)."""
        rec = {"t_kernel": timed(kernel, iters),
               "t_kernel_eager": timed(kernel, iters, graph=False),
               "t_plain": timed(plain, max(3, iters // 5), graph=False),
               "t_library": timed(library, iters) if library else None}
        rec.update(ms=rec["t_kernel"]["ms"], plain_ms=rec["t_plain"]["ms"],
                   library_ms=rec["t_library"]["ms"] if library else None)
        return rec

    def timing_text(rec, lib_name):
        lib = (f"{lib_name} {fmt(rec['t_library'])}" if rec["t_library"]
               else "no library call")
        return (f"kernel {fmt(rec['t_kernel'])} [issued eagerly "
                f"{fmt(rec['t_kernel_eager'])}] plain {fmt(rec['t_plain'])} "
                f"{lib}")

    # ---------------------------------------------------------------- 1
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    build_s = build.build_all()
    reg_counts = {n: [int(r) for r in re.findall(r"Used (\d+) registers",
                                                 build.build_log(n))]
                  for n in build.SOURCES}
    say(f"phase 1 device: {kind} | nvidia-smi: {smi} | "
        f"capability {torch.cuda.get_device_capability(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{build_s:.1f} s | ptxas registers per kernel {reg_counts}")
    result["phases"]["device"] = dict(smi=smi, kind=kind, build_s=build_s,
                                      registers=reg_counts)

    gen = torch.Generator(device=dev).manual_seed(0)
    T, E, D, B, NNZ = 8, 100_000, 64, 2048, 10  # the CLI's default width

    def main_path_ids():
        """(B*T, NNZ) bags over the flat (T*E, D) table, as the trainer's
        lookup forms them."""
        per_table = torch.randint(0, E, (B, T, NNZ), generator=gen,
                                  device=dev, dtype=torch.int32)
        offs = (torch.arange(T, device=dev, dtype=torch.int32) * E)
        return (per_table + offs[None, :, None]).reshape(B * T, NNZ)

    # ---------------------------------------------------------------- 2 + 4
    k1 = {}

    def k1_case(name, table, idx_list, rtol, iters):
        i0 = idx_list[0]
        got = emb_gather_cuda(table, i0).float()
        want = emb_gather_plain(table, i0).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"K1 {name}: non-finite output")
        err = (got - want).abs().max().item()
        tol = rtol * want.abs().max().item()
        if not err <= tol:
            fail(f"K1 {name}: max abs err {err:.3e} > tolerance {tol:.3e}")
        nb, nnz = i0.shape
        dim, es = table.shape[1], table.element_size()
        uniq = torch.unique(i0).numel()  # shifts are bijections: same count
        nbytes = uniq * dim * es + nb * nnz * 4 + nb * dim * es
        b_ms, b_by = bound_ms(nbytes, nb * nnz * dim)
        long_list = [i.long() for i in idx_list]
        cyc = {"k": 0}

        def nxt(lst):
            cyc["k"] = (cyc["k"] + 1) % len(lst)
            return lst[cyc["k"]]

        rec = timings(lambda: emb_gather_cuda(table, nxt(idx_list)),
                      lambda: emb_gather_plain(table, nxt(idx_list)),
                      lambda: F.embedding_bag(nxt(long_list), table,
                                              mode="sum"), iters)
        rec.update(shape=f"table {tuple(table.shape)} {str(table.dtype)[6:]}, "
                         f"{nb} bags x {nnz}", max_abs_err=err, tol=tol,
                   bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                   bytes=nbytes, gbps=nbytes / rec["ms"] / 1e6)
        k1[name] = rec
        say(f"phase 2/4 K1 {name}: {rec['shape']} max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) | {timing_text(rec, 'F.embedding_bag')} "
            f"({rec['gbps']:.0f} GB/s) bound {b_ms:.4f} ms ({b_by}) | {smi}")

    RH, DH, BH, NH = 1_000_000, 128, 8192, 30  # bench.py's headline shape
    head = torch.rand((RH, DH), generator=gen, device=dev)
    base = torch.randint(0, RH, (BH, NH), generator=gen, device=dev,
                         dtype=torch.int32)
    k1_case("headline_f32", head,
            [((base + s) % RH).to(torch.int32) for s in range(8)], 1e-5, 50)
    del head, base
    flat = torch.randn((T * E, D), generator=gen, device=dev) / math.sqrt(E)
    ids = [main_path_ids() for _ in range(8)]
    k1_case("dlrm_f32", flat, ids, 1e-5, 100)
    k1_case("dlrm_bf16", flat.to(torch.bfloat16), ids, 8e-3, 100)
    result["phases"]["k1"] = k1

    # ---------------------------------------------------------------- 3 + 4
    R = T * E
    gidx = main_path_ids().reshape(B, T, NNZ).transpose(0, 1).reshape(-1)
    rows_g = torch.randn((gidx.numel(), D), generator=gen, device=dev) * 1e-3
    rows, totals = dedup_row_updates(gidx, rows_g, R)
    n_valid = int((rows < R).sum().item())
    valid_rows = rows[:n_valid].long()
    lr, eps = 0.01, 1e-7
    k2 = {}
    for mode in ("adagrad", "sgd"):
        upd = totals if mode == "adagrad" else -lr * totals
        t_k, t_p = flat.clone(), flat.clone()
        a_k = torch.full_like(flat, 0.1) if mode == "adagrad" else None
        a_p = a_k.clone() if a_k is not None else None
        sparse_update_cuda(t_k, rows, upd, a_k, lr=lr, eps=eps)
        sparse_update_plain(t_p, rows, upd, a_p, lr=lr, eps=eps)
        torch.cuda.synchronize()
        err = (t_k - t_p).abs().max().item()
        tol = 1e-5 * t_p.abs().max().item()
        if a_k is not None:
            err = max(err, (a_k - a_p).abs().max().item())
            tol = max(tol, 1e-5 * a_p.abs().max().item())
        changed = (t_k[valid_rows] != flat[valid_rows]).any(-1).float().mean()
        if not err <= tol or changed.item() < 0.99:
            fail(f"K2 {mode}: max abs err {err:.3e} (tol {tol:.3e}), "
                 f"share of rows changed {changed.item():.3f}")
        row_transfers = 5 if mode == "adagrad" else 3  # u, T (and A) in; T (A) out
        nbytes = rows.numel() * 4 + n_valid * D * 4 * row_transfers
        b_ms, b_by = bound_ms(nbytes, n_valid * D * (6 if mode == "adagrad"
                                                      else 1))
        vt = upd[:n_valid]
        rec = timings(
            lambda: sparse_update_cuda(t_k, rows, upd, a_k, lr=lr, eps=eps),
            lambda: sparse_update_plain(t_p, rows, upd, a_p, lr=lr, eps=eps),
            (lambda: t_p.index_add_(0, valid_rows, vt)) if mode == "sgd"
            else None, 100)
        rec.update(shape=f"table ({R}, {D}) f32, {rows.numel()} slots, "
                         f"{n_valid} valid", max_abs_err=err, tol=tol,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                   gbps=nbytes / rec["ms"] / 1e6)
        k2[mode] = rec
        say(f"phase 3/4 K2 {mode}: {rec['shape']} max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) | {timing_text(rec, 'index_add_')} "
            f"({rec['gbps']:.0f} GB/s) bound {b_ms:.4f} ms ({b_by}) | {smi}")
        del t_k, t_p, a_k, a_p
    result["phases"]["k2"] = k2
    del flat, ids, rows_g, rows, totals, valid_rows
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 5
    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
    from param_tpu_torch.models.dlrm_data import RandomDataset
    from param_tpu_torch.ops.mlp import tree_map

    small = dict(num_tables=4, rows_per_table=1000, emb_dim=32, nnz=6,
                 dense_dim=16, bot_mlp=[64, 32], top_mlp=[64, 1], batch=256)
    cpu_m = DlrmModel(DlrmConfig(**small), device="cpu")
    gpu_m = DlrmModel(DlrmConfig(**small), device="cuda")
    batch = next(iter(RandomDataset(batch=256, dense_dim=16, num_tables=4,
                                    nnz=6, num_rows=1000, num_batches=1,
                                    seed=3)))
    worst = 0.0
    for opt in ("forward", "sparse_sgd", "sparse_adagrad"):
        p_c = cpu_m.init_params(0)
        p_g = tree_map(lambda t: t.detach().to(dev).requires_grad_(True), p_c)
        b_c, b_g = cpu_m.place_batch(batch), gpu_m.place_batch(batch)
        if opt == "forward":
            with torch.no_grad():
                outs = [(cpu_m.forward(p_c, *b_c[:2]),
                         gpu_m.forward(p_g, *b_g[:2]))]
        elif opt == "sparse_sgd":
            cpu_m.make_sparse_sgd_step(0.05)(p_c, *b_c)
            gpu_m.make_sparse_sgd_step(0.05)(p_g, *b_g)
            outs = [(p_c["tables"], p_g["tables"])]
        else:
            a_c, a_g = cpu_m.init_adagrad_state(p_c), gpu_m.init_adagrad_state(p_g)
            cpu_m.make_sparse_adagrad_step(0.05)(p_c, a_c, *b_c)
            gpu_m.make_sparse_adagrad_step(0.05)(p_g, a_g, *b_g)
            outs = [(p_c["tables"], p_g["tables"]),
                    (a_c["tables"], a_g["tables"])]
        for want, got in outs:
            want, got = want.detach(), got.detach().cpu()
            err = (want - got).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-6
            worst = max(worst, err)
            if not err <= tol:
                fail(f"model parity {opt}: card vs CPU max abs err "
                     f"{err:.3e} > {tol:.3e}")
    say(f"phase 5 model parity: small DLRM logits and one sparse_sgd / "
        f"sparse_adagrad step on the card match the CPU plain path, max abs "
        f"err {worst:.3e} (tol 1e-4 x max|value| + 1e-6)")
    result["phases"]["model_parity_max_abs_err"] = worst

    # ---------------------------------------------------------------- 6
    from param_tpu_torch.cli import dlrm as cli

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for opt in ("sparse_adagrad", "sparse_sgd", "adagrad"):
        before = dict(kernels.launch_counts)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--train-batches", "5", "--optimizer", opt,
                           "--device", "cuda"])
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        losses = [float(x) for x in re.findall(r"loss (\S+)", out)]
        e2e = [ln for ln in out.splitlines() if ln.startswith("DLRM-E2E")]
        if rc != 0 or len(losses) != 5 or not e2e:
            fail(f"trainer {opt}: rc {rc}, output:\n{out}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"trainer {opt}: non-finite loss {losses}")
        delta = {k: kernels.launch_counts[k] - before[k] for k in before}
        if delta["emb_gather"] <= 0:
            fail(f"trainer {opt}: K1 was not launched ({delta})")
        if opt.startswith("sparse") and \
                delta[f"sparse_update_{opt[len('sparse_'):]}"] <= 0:
            fail(f"trainer {opt}: K2 was not launched ({delta})")
        fields = dict(re.findall(r"(\w[\w-]*)=(\S+)", e2e[0]))
        runs[opt] = dict(losses=losses, launches=delta, wall_s=wall,
                         step_ms=float(fields["step_ms"]),
                         qps=float(fields["QPS"]), auc=fields["AUC"])
        say(f"phase 6 trainer {opt}: full width (8 x 100000 x 64, batch "
            f"2048, nnz 10), 5 steps, losses {[round(x, 5) for x in losses]} "
            f"| steady step {runs[opt]['step_ms']:.3f} ms, QPS "
            f"{runs[opt]['qps']:.0f} | launches {delta} | {smi}")
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"phase 6 main path launches {launches}, peak device memory "
        f"{peak_gb:.2f} GB")
    result["phases"]["trainer"] = runs
    result["launches"] = launches
    result["peak_memory_gb"] = peak_gb

    # ---------------------------------------------------------------- 7
    from param_tpu_torch.kernels.gemm import (
        gemm_cuda, gemm_plain, gemm_wres_cuda, gemm_wres_plain,
    )
    from param_tpu_torch.kernels.int4_gemm import (
        int4_dequant, int4_gemm_cuda, int4_gemm_plain,
    )

    def gemm_tol(want):
        """f32: 1e-4 x max|out| (long sums in another order); bf16: one
        bf16 ulp of max|out| (one rounding of an f32 sum on each side)."""
        ref = want.float().abs().max().item()
        if want.dtype == torch.float32:
            return 1e-4 * ref
        return 2.0 ** (math.floor(math.log2(ref)) - 7)

    def check(name, got, want, tol):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{name}: shape {tuple(got.shape)} (want "
                 f"{tuple(want.shape)}) or non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            fail(f"{name}: max abs err {err:.3e} > tolerance {tol:.3e}")
        return err

    k3 = {}
    for dt, shapes in ((torch.bfloat16, [(1024, 4096, 4096), (4096, 4096, 128),
                                         (128, 1024, 1024), (100, 100, 100)]),
                       (torch.float32, [(1024, 4096, 4096), (4096, 4096, 128),
                                        (128, 1024, 1024), (1024, 1024, 4096),
                                        (100, 100, 100)])):
        for m, n, k in shapes:
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            b = torch.randn((k, n), generator=gen, device=dev).to(dt)
            want = gemm_plain(a, b)
            name = f"{str(dt)[6:]} {(m, n, k)}"
            err = check(f"K3 {name}", gemm_cuda(a, b), want, gemm_tol(want))
            es = a.element_size()
            b_ms, b_by = bound_ms((m * k + k * n + m * n) * es, 2 * m * n * k,
                                  fp32=dt == torch.float32)
            rec = timings(lambda: gemm_cuda(a, b), lambda: gemm_plain(a, b),
                          lambda: torch.matmul(a, b), 20)
            rec.update(shape=f"({m}, {k}) @ ({k}, {n}) {str(dt)[6:]}",
                       max_abs_err=err, tol=gemm_tol(want), bound_ms=b_ms,
                       bound_by=b_by, tflops=2 * m * n * k / rec["ms"] / 1e9)
            k3[name] = rec
            say(f"phase 7 K3 {rec['shape']}: max_abs_err {err:.3e} (tol "
                f"{rec['tol']:.3e}) | {timing_text(rec, 'torch.matmul')} "
                f"({rec['tflops']:.1f} TF/s) bound {b_ms:.4f} ms ({b_by}) | "
                f"{smi}")
            del a, b, want
    result["phases"]["k3"] = k3

    # ---------------------------------------------------------------- 8
    S, m, k, n = 8, 128, 4096, 4096
    a = torch.randn((S, m, k), generator=gen, device=dev).bfloat16()
    b = torch.randn((k, n), generator=gen, device=dev).bfloat16()
    want = gemm_wres_plain(a, b)
    err = check("K4", gemm_wres_cuda(a, b), want, gemm_tol(want))
    a2 = a.reshape(S * m, k)
    b_ms, b_by = bound_ms((S * m * k + k * n + S * m * n) * 2,
                          S * 2 * m * n * k, fp32=False)
    k4 = timings(lambda: gemm_wres_cuda(a, b), lambda: gemm_wres_plain(a, b),
                 lambda: torch.matmul(a2, b), 20)
    k4.update(shape=f"S={S} x ({m}, {k}) @ ({k}, {n}) bf16", max_abs_err=err,
              tol=gemm_tol(want), bound_ms=b_ms, bound_by=b_by,
              per_gemm_ms=k4["ms"] / S,
              tflops=S * 2 * m * n * k / k4["ms"] / 1e9)
    say(f"phase 8 K4 {k4['shape']}: max_abs_err {err:.3e} (tol "
        f"{k4['tol']:.3e}) | {timing_text(k4, 'torch.matmul (stacked A)')} "
        f"| per GEMM {k4['per_gemm_ms']:.4f} ms ({k4['tflops']:.1f} TF/s) "
        f"bound {b_ms:.4f} ms ({b_by}) | {smi}")
    result["phases"]["k4"] = k4
    del a, b, a2, want

    # ---------------------------------------------------------------- 9
    k5 = {}
    G = 128
    for m, k, n in [(mm, kk, nn) for mm in (1, 8, 32)
                    for kk, nn in ((4096, 11008), (11008, 4096))] + \
            [(512, 4096, 4096)]:
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen,
                               device=dev, dtype=torch.int32).to(torch.int8)
        scale = torch.rand((k // G, n), generator=gen, device=dev) * 0.02
        want = int4_gemm_plain(x, packed, scale, torch.float32)
        tol = 1e-5 * want.abs().max().item()
        err = check(f"K5 {(m, k, n)}",
                    int4_gemm_cuda(x, packed, scale, torch.float32), want, tol)
        nbytes = k * n // 2 + (k // G) * n * 4 + m * k * 2 + m * n * 2
        b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, fp32=False)
        w_bf16 = int4_dequant(packed, scale).bfloat16()
        rec = timings(lambda: int4_gemm_cuda(x, packed, scale),
                      lambda: int4_gemm_plain(x, packed, scale), None,
                      50 if m <= 32 else 10)
        rec["dequant_matmul"] = timed(lambda: torch.matmul(x, w_bf16), 50)
        rec.update(shape=f"({m}, {k}) @ int4 ({k}, {n}) g={G}, bf16 out",
                   max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
                   gbps=nbytes / rec["ms"] / 1e6)
        k5[f"{(m, k, n)}"] = rec
        say(f"phase 9 K5 {rec['shape']}: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) | {timing_text(rec, '')} ({rec['gbps']:.0f} GB/s) "
            f"bound {b_ms:.4f} ms ({b_by}) | not the same function: "
            f"torch.matmul on the dequantized bf16 weight "
            f"{fmt(rec['dequant_matmul'])} | {smi}")
        del x, packed, scale, want, w_bf16
    result["phases"]["k5"] = k5
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 10
    from param_tpu_torch.cli import compute as compute_cli
    from param_tpu_torch.cli import inference as inference_cli
    from param_tpu_torch.ops.inference import (
        mlp_forward_int4, pack_int4_mlp, quantize_weights_int4,
    )
    from param_tpu_torch.ops.mlp import init_mlp

    def drive(label, cli_main, argv, table_rows, must):
        """Run a CLI (median of 5 timed windows) with the counts reset just
        before and read just after; its table must have ``table_rows`` rows
        of finite numbers and every kernel of ``must`` must have launched."""
        kernels.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv + ["--reps", "5", "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launch_counts.items() if v}
        out = buf.getvalue()
        rows = [ln for ln in out.splitlines()
                if re.match(r"\s*(gemm|emb|mlp|mlp_infer)\s+\(", ln)
                or re.match(r"\s*\d+\s+\d+\s+\d+\s+(torch|K3)\s", ln)]
        nums = [float(x) for ln in rows
                for x in re.findall(r"\s(-?[\d.]+(?:e[+-]?\d+)?)%?(?=\s|$)",
                                    ln.split(")")[-1])]
        if rc != 0 or len(rows) != table_rows or not nums or \
                not all(math.isfinite(v) for v in nums):
            fail(f"phase 10 {label}: rc {rc}, {len(rows)} result rows (want "
                 f"{table_rows}), output:\n{out}")
        missing = [k for k in must if counts.get(k, 0) <= 0]
        if missing:
            fail(f"phase 10 {label}: {missing} not launched ({counts})")
        say(f"phase 10 {label}: {' '.join(argv)} | {wall:.1f} s | launches "
            f"{counts} | {smi}\n{out.rstrip()}")
        return dict(argv=argv, launches=counts, wall_s=wall, output=out)

    cli_runs = {
        "gemm_A_bf16_K3": drive(
            "gemm A bf16 K3", compute_cli.main,
            ["gemm", "--dataset", "A", "--dtype", "bfloat16", "--pallas"],
            15, ["gemm_bf16"]),
        "gemm_C_compare": drive(
            "gemm C compare", compute_cli.main,
            ["gemm", "--dataset", "C", "--compare"], 8, ["gemm_f32"]),
        "gemm_wres_K4": drive(
            "gemm weight-resident K4", compute_cli.main,
            ["gemm", "--weight-resident", "8", "--shape", "128,4096,4096",
             "--dtype", "bfloat16"], 1, ["gemm_wres"]),
        "emb_baseline_K1": drive(
            "emb baseline K1", compute_cli.main,
            ["emb", "--dataset", "baseline"], 1, ["emb_gather"]),
        "linear": drive(
            "linear", compute_cli.main,
            ["linear", "--shape", "18,1024,1024,1024,512"], 1, []),
        "inference_int4_K5": drive(
            "inference int4 K5", inference_cli.main,
            ["--shape", "18,4096,4096,4096,512", "--dtype", "int4"], 1,
            ["int4_gemm"]),
    }
    # the rungs beside it (cuBLAS, no kernel of the port), and serving
    # batch 1, for the int4-against-int8 comparison
    for dtype, batch in (("int8", 512), ("bfloat16", 512), ("int4", 1),
                         ("int8", 1)):
        cli_runs[f"inference_{dtype}_b{batch}"] = drive(
            f"inference {dtype} batch {batch}", inference_cli.main,
            ["--shape", f"18,4096,4096,4096,{batch}", "--dtype", dtype], 1,
            ["int4_gemm"] if dtype == "int4" else [])
    if cli_runs["inference_int4_K5"]["launches"]["int4_gemm"] % 18:
        fail("phase 10: the int4 bench's K5 launches are not 18 per forward")

    # one full-width int4 forward: exactly 18 K5 launches
    qp = pack_int4_mlp(quantize_weights_int4(init_mlp(
        torch.Generator(device=dev).manual_seed(0), [4096] * 19, device=dev)))
    xq = torch.rand((512, 4096), generator=gen, device=dev).bfloat16()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = mlp_forward_int4(qp, xq)
    torch.cuda.synchronize()
    if kernels.launch_counts["int4_gemm"] != 18 or out.shape != (512, 4096) \
            or not torch.isfinite(out.float()).all():
        fail(f"phase 10: one int4 forward launched K5 "
             f"{kernels.launch_counts['int4_gemm']} times (want 18), output "
             f"{tuple(out.shape)}")
    del qp, xq, out
    # a small int4 MLP on the card (M 5 and 96: both K5 schedules) against
    # the CPU plain path; each layer's output is rounded to bf16 on both
    cpu_p = init_mlp(torch.Generator().manual_seed(1), [256, 512, 256, 128],
                     device="cpu")
    q_cpu = pack_int4_mlp(quantize_weights_int4(cpu_p))
    q_gpu = [tuple(t.to(dev) for t in layer) for layer in q_cpu]
    worst = 0.0
    for mm in (5, 96):
        xs = torch.rand((mm, 256), generator=torch.Generator().manual_seed(mm))
        want = mlp_forward_int4(q_cpu, xs.bfloat16()).float()
        got = mlp_forward_int4(q_gpu, xs.bfloat16().to(dev)).float().cpu()
        err = (got - want).abs().max().item()
        tol = 2e-2 * want.abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            fail(f"phase 10: int4 MLP card vs CPU (M={mm}) max abs err "
                 f"{err:.3e} > {tol:.3e}")
    say(f"phase 10 int4 forward: 18 K5 launches per full-width forward; "
        f"small int4 MLP card vs CPU max abs err {worst:.3e} (tol 2e-2 x "
        f"max|out|, one bf16 rounding per layer) | {smi}")
    result["phases"]["cli"] = cli_runs

    # ---------------------------------------------------------------- report
    def entry(name, source, replaces, n_launches, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shape": rec["shape"], "ms_min": rec["t_kernel"]["min"],
                "ms_max": rec["t_kernel"]["max"],
                "ms_issued_eagerly": rec["t_kernel_eager"]["ms"]}

    def cli_launches(run, key):
        return cli_runs[run]["launches"].get(key, 0)

    src = "param_tpu_torch/kernels/csrc/"
    report = {"kernels": [
        entry("emb_gather (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185", launches["emb_gather"],
              k1["dlrm_f32"]),
        entry("sparse_update adagrad (K2)", src + "sparse_update.cu",
              "param_tpu/ops/sparse_update.py:117",
              launches["sparse_update_adagrad"], k2["adagrad"]),
        entry("sparse_update sgd (K2)", src + "sparse_update.cu",
              "param_tpu/ops/sparse_update.py:117",
              launches["sparse_update_sgd"], k2["sgd"]),
        entry("gemm f32 (K3)", src + "gemm.cu", "param_tpu/ops/matmul.py:97",
              cli_launches("gemm_C_compare", "gemm_f32"),
              k3["float32 (1024, 1024, 4096)"]),
        entry("gemm bf16 (K3)", src + "gemm.cu", "param_tpu/ops/matmul.py:97",
              cli_launches("gemm_A_bf16_K3", "gemm_bf16"),
              k3["bfloat16 (1024, 4096, 4096)"]),
        entry("gemm weight-resident bf16 (K4)", src + "gemm.cu",
              "param_tpu/ops/matmul.py:38",
              cli_launches("gemm_wres_K4", "gemm_wres"), k4),
        entry("int4 gemm (K5)", src + "int4_gemm.cu",
              "param_tpu/ops/matmul.py:196",
              cli_launches("inference_int4_K5", "int4_gemm"),
              k5["(512, 4096, 4096)"]),
    ]}
    result.update(report)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    say(smi)
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the full results as JSON to PATH")
    sys.exit(main(ap.parse_args().out))
