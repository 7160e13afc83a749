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
  4. Timings with CUDA events after a warm-up: kernel, plain version, one
     library call computing the same function, and the least time the card
     could take (bytes over 3.35 TB/s, or operations over 67 TF/s f32).
  5. Model parity: a small DLRM's logits and one step of each sparse
     optimizer on the card (kernels) against the same on the CPU (plain
     versions).
  6. The DLRM trainer at the CLI's full default width through
     ``param_tpu_torch.cli.dlrm.main`` for 5 batches each of sparse_adagrad,
     sparse_sgd and dense adagrad, with the launch counts reset just before
     and read just after: K1 and K2 must have launched.
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
    from param_tpu_torch.utils.timer import time_ms

    dev = resolve_device("cuda")
    require_sm90(dev)
    result = {"phases": {}}

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

        ms = time_ms(lambda: emb_gather_cuda(table, nxt(idx_list)), iters)
        plain_ms = time_ms(lambda: emb_gather_plain(table, nxt(idx_list)),
                           max(3, iters // 5))
        lib_ms = time_ms(lambda: F.embedding_bag(nxt(long_list), table,
                                                 mode="sum"), iters)
        rec = dict(shape=f"table {tuple(table.shape)} {str(table.dtype)[6:]}, "
                         f"{nb} bags x {nnz}", max_abs_err=err, tol=tol,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                   bytes=nbytes, gbps=nbytes / ms / 1e6)
        k1[name] = rec
        say(f"phase 2/4 K1 {name}: {rec['shape']} max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) | kernel {ms:.4f} ms ({rec['gbps']:.0f} GB/s) "
            f"plain {plain_ms:.4f} ms F.embedding_bag {lib_ms:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by}) | {smi}")

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
        ms = time_ms(lambda: sparse_update_cuda(t_k, rows, upd, a_k, lr=lr,
                                                eps=eps), 100)
        plain_ms = time_ms(lambda: sparse_update_plain(t_p, rows, upd, a_p,
                                                       lr=lr, eps=eps), 10)
        lib_ms = None
        if mode == "sgd":
            vt = upd[:n_valid]
            lib_ms = time_ms(lambda: t_p.index_add_(0, valid_rows, vt), 100)
        rec = dict(shape=f"table ({R}, {D}) f32, {rows.numel()} slots, "
                         f"{n_valid} valid", max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes, gbps=nbytes / ms / 1e6)
        k2[mode] = rec
        lib = f"index_add_ {lib_ms:.4f} ms" if lib_ms is not None else \
            "no library call"
        say(f"phase 3/4 K2 {mode}: {rec['shape']} max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) | kernel {ms:.4f} ms ({rec['gbps']:.0f} GB/s) "
            f"plain {plain_ms:.4f} ms {lib} bound {b_ms:.4f} ms ({b_by}) | "
            f"{smi}")
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

    # ---------------------------------------------------------------- report
    def entry(name, source, replaces, count_key, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[count_key],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shape": rec["shape"]}

    k1_src = "param_tpu_torch/kernels/csrc/emb_gather.cu"
    k2_src = "param_tpu_torch/kernels/csrc/sparse_update.cu"
    report = {"kernels": [
        entry("emb_gather (K1)", k1_src, "param_tpu/ops/embedding.py:185",
              "emb_gather", k1["dlrm_f32"]),
        entry("sparse_update adagrad (K2)", k2_src,
              "param_tpu/ops/sparse_update.py:117", "sparse_update_adagrad",
              k2["adagrad"]),
        entry("sparse_update sgd (K2)", k2_src,
              "param_tpu/ops/sparse_update.py:117", "sparse_update_sgd",
              k2["sgd"]),
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
