#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device and build: CUDA and sm_90 present; the card's name and power
     limit; every hand-written kernel built from ``param_tpu_torch/kernels/
     csrc`` (one nvcc per source, in parallel); ptxas's registers and
     spills per library, and per K6 / K7 kernel.
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
     same inputs, TF32 off) in bf16, f16 and f32 at GEMM_A / GEMM_C shapes
     (with the split-K shapes (128, 1024, 1024) and (1024, 1024, 128)) and
     a ragged (100, 100, 100); library call torch.matmul in the same dtype.
     Each row names the path taken (wgmma, mma_sync or simt, from the
     launch counters) and its K splits; an aligned 16-bit shape must take
     wgmma.  A planted fault (one element of B negated between the plain
     call and the kernel's) must break the tolerance.
  8. K4 (weight-resident GEMMs): S = 8 x (128, 4096, 4096) bf16, on the
     wgmma path; library call torch.matmul on the stacked A.
  9. K5 (int4 GEMM): llama2-7B MLP projections (M, 4096) @ (4096, 11008)
     and (M, 11008) @ (11008, 4096), g = 128, at M = 1, 8, 32, and MLP_A's
     (512, 4096) @ (4096, 4096), with bf16-exact scales.  Each row names
     its path (stream up to M = 32, wgmma at 512, from the launch
     counters) and K splits; its f32-output kernel is held to 1e-5 x
     max |want| and its bf16-output kernel (the main path's) to one bf16
     ulp of max |want| against the plain version rounded to bf16, and so
     is the parent's design (mma_sync and its reduce kernel, the path of
     unaligned products); each must give the same bits twice.  It prints the
     ptxas registers and spills of its path's kernels and the profiler's
     kernel split (one kernel; the parent design's main kernel and its
     reduce), and times the parent's design (the mma_sync kernel and its
     reduce kernel, still in the source) beside it.  A planted fault (one
     packed byte changed between the plain call and the kernel's, at M = 1
     and 512) must break the tolerance.  Library call:
     torch._weight_int4pack_mm on the same nibbles (q + 8 unsigned, zero
     point 0, bf16 scales; the one-off _convert_weight_to_int4pack is not
     timed); torch.matmul on the dequantized bf16 weight is timed beside it
     as a different function.
 10. The compute-tier CLIs in-process at full width, the launch counts
     reset before each command and read after it: ``cli.compute gemm``
     (GEMM_A bf16 through K3's wgmma path; GEMM_C --compare; --weight-
     resident 8 through K4), ``emb --dataset baseline`` (K1), ``linear``, and
     ``cli.inference --dtype int4`` (K5, 18 layers, all on the wgmma path;
     beside it the int8 and bf16 rungs, and int4 / int8 at batch 1); one
     int4 forward launches K5 exactly 18 times, all on wgmma, and a small
     int4 MLP on the card agrees with the CPU plain path.
 11. K6 (flash-attention forward) against its plain version (f32
     attention on upcast inputs) with the logsumexp: llama2 (1, 32, 2048,
     128) causal, gpt2 (8, 12, 1024, 64), GQA 32 / 8 heads, a window of
     512, S_q 128 < S_k 2048 causal, f32 (the tf32x3 path) at llama2 (1,
     32, 2048, 128) causal, gpt2 (8, 12, 1024, 64) and (1, 4, 512, 64)
     causal, and a ragged length 1000; library call
     F.scaled_dot_product_attention (enable_gqa for GQA, the boolean mask
     for the window and the rectangular case).  Each row names the path it
     took (from the launch counters), which must be the one
     ``flash_schedule`` gives and, for 16-bit inputs at D 64 / 128, wgmma.
     Every element is held to its own bound (``flash_fwd_tolerance``), and
     that bound must flag a planted fault (a dropped diagonal kv entry) on
     the bf16 and the f32 llama2 rows.  f32 rows are bounded at the
     split-TF32 rate (TF32 / 3, 165 TF/s).
 12. Transformer parity: a small block (emb 512, 8 heads; f32, f32 GQA and
     bf16) through block_apply (flash), prefill, four windowed decode_steps
     and an int4 decode_step on the card against the same on the CPU.
 13. The serving CLIs in-process at llama2 width with launch counts:
     ``attention --dataset llama2 --paths xla,flash,dpa`` and
     ``transformer --dataset llama2 --fwd-only`` (K6), ``attention
     --dtype float32 --paths flash,dpa`` at llama2 and gpt2 (K6 on the
     tf32x3 path), ``decode --dataset
     llama3-gqa``, ``serve --dataset llama2`` in bf16 and int4 (K5, exactly
     4 launches per decode step, all on the stream path); K5 alone (as in
     phase 9) at the serve path's QKV (M, 4096) @ (4096, 12288) and output
     (M, 4096) @ (4096, 4096) projections at M = 1, 8, 32; host-clock time
     against the card's kernel time (torch.profiler) for the llama2 block
     forward and the bf16 / int4 decode step at batch 1 and 32, the int4
     step also with K5 on the parent's design.
 14. K7 (flash-attention backward) against its plain version (f32 on
     upcast inputs) from K6's output and lse and a random dO: llama2 (1,
     32, 2048, 128) causal, contiguous and in the train step's layout
     (q / k / v strided head views of one fused projection, dO a
     transposed-head view), the other ATTN_LLAMA2 shapes (1, 32, 4096,
     128) and (4, 32, 2048, 128) causal, gpt2 (8, 12, 1024, 64), GQA 32 /
     8 heads, S_q 128 < S_k 2048 causal, f32 at llama2 (1, 32, 2048, 128)
     causal, gpt2 (8, 12, 1024, 64) and (1, 4, 512, 64) causal, a ragged
     length 1000 and head dim 32; each row's path as in phase 11; every
     element of dq, dk and dv within its own bound
     (``flash_bwd_tolerance``), which must flag a planted fault (a dropped
     diagonal kv entry) in each on the bf16 and f32 llama2 rows; those two
     rows run twice must give bitwise-equal gradients; library call
     aten._scaled_dot_product_flash_attention_backward on SDPA's own
     forward residuals where it computes the same function, and for GQA
     and f32 SDPA's backward through autograd (enable_gqa for GQA), timed
     by its kernel time in torch.profiler, with the kernels that name the
     backend PyTorch picked (K7 is timed that way too on those rows).
 15. Train-step parity: a small block (emb 512, 8 heads; f32, f32 GQA and
     bf16) trained two steps by make_train_step on the card against the
     same on the CPU, losses and every parameter; K6 and K7 launch once
     per step.
 16. The training CLIs in-process at llama2 width with launch counts:
     ``attention --dataset llama2 --grad --paths xla,flash,dpa`` (one K7
     per K6), ``transformer --dataset llama2 --paths flash,xla`` (K6 and
     K7 exactly once per flash train step) and ``attention --dataset llama2
     --dtype float32 --grad --paths flash,dpa`` (K6 and K7 on the tf32x3
     path); host-clock time against the
     card's kernel time for the llama2 train step on flash and xla, with
     the shares of K6, K7 and the cuBLAS GEMMs.
 17. K8a-d (ring all-gather, ring reduce-scatter, both-direction ring
     all-gather, loopback) on one card: first the op API of
     ``param_tpu_torch.ops.ring_collectives`` (ring_all_gather,
     ring_all_reduce, ring_all_gather_bidir, loopback_remote_copy) at n 1,
     2, 4, 8 ranks, 1 MiB a rank, and at n 8, 8 MiB, with the launch counts
     reset before and read after: every kernel, and K8a / K8b on each of
     their routes (copy, memory, K8b's cluster), must have launched;
     then each kernel against its plain version at n 1, 2, 4, 8 with
     per-rank payloads of 4 KiB, 1 MiB and 64 MiB in f32 and 1 MiB in
     bf16, every byte equal; a planted fault (rank 0 sends its first hop
     to right + 1) must raise from the bounded wait, and the next call
     must be right again (K8b on both its routes).  Each K8a-d row
     prints its plan (blocks a rank, slice bytes, lag, slots and where
     they are, scope); each K8b row over 2 to 8 ranks is also held and
     timed on its other route (cluster or memory, through
     ``ring.forced_route``), and K8b also runs at 2, 4 and 16 MiB a rank
     on both routes, about where ``ring_plan`` switches between them.
     Library yardsticks, on a
     stack X of the shards made before the timed window: K8a and K8c
     ``X.expand(n, n, L).contiguous()`` (``X.clone()`` over one rank,
     where that is a view), K8b ``X.view(n, n, c).sum(0)``, K8d
     ``X.clone()``.  K8d's n = 1, 64 MiB row also times, in the same
     call, the kernel K8a-c take over one rank (the same copy without
     the handshake).
     With two or more cards the rings also run with one rank per card,
     timed beside NCCL's all-gather and reduce-scatter at the same per-rank
     shape (``torch.cuda.nccl``), and once behind a peer card still busy
     with earlier work; with one card the wire between cards is unchecked.
 18. ``cli.comms`` on the card: a world of one on NCCL in-process,
     all_reduce, all_gather, reduce_scatter, all_to_all, broadcast and
     pt2pt from 8 B to 64 MiB with dcheck, and all_reduce / all_gather
     replayed from CUDA graphs (``--mode graph``); with two or more cards
     also ``torchrun`` worlds of all of them (pairwise pt2pt eagerly and
     from CUDA graphs among them); every row's dcheck OK.
 19. The coalesced-fetch kernels and the headline bench, at the
     experiment's full sizes (table 1,048,576 x 128 f32): K9 (k-row bulk
     fetch, tile sums) at k 1, 2, 4, 8, 16, 32 (262,144 rows, 4096 a tile)
     against its plain version within rtol 1e-4, timed beside
     ``F.embedding_bag`` over each tile's row ids (its library call), and a
     planted fault (one start shifted by one row) must break that
     comparison; K10 (block-
     coalesced bag, r_blk 8, 16 bags a tile) at B 8192 x nnz 32 uniform and
     zipf ids against the plain bag (K1's) within rtol 1e-5, and K1 at the
     same ids (stage B's shape) against it too; timed beside K1, the
     pre-pass + K10 path and F.embedding_bag (its library call).  Then
     ``param_tpu_torch.bench.main()`` (the 1M x 128 headline through K1)
     and ``experiments.coalesce.main()`` (--verify, then stages A and B)
     in-process, the launch counts reset before and read after: K1, K9 and
     K10 must each have launched, and the bench's JSON line must hold a
     finite GB/s.
 20. The sharded DLRM (``DlrmModel`` over a ``torch.distributed`` group):
     in a world of one on NCCL at the CLI's full default width, two steps
     each of dense adagrad, sparse_sgd and sparse_adagrad against the
     single-device model on the card (rtol 1e-5, atol 1e-6 on losses,
     parameters and accumulators); ``cli.dlrm.main`` with no flags (the
     per-region bench) and with ``--optimizer sparse_adagrad``, all 21
     reference rows finite and positive and a ``QPS:`` line; its
     ``--print-comms`` pattern.  The launch counts are reset before each
     sharded run and read after: K1 and K2 must have launched.  With two or
     more cards, ``cli.dlrm`` under torchrun over all of them:
     ``--train-batches 5`` for each optimizer (rank 0's first loss equal to
     phase 6's within rtol 1e-5) and the default bench.
 21. The multi-device transformer tier in a world of one on NCCL at
     llama2-7B width (``param_tpu_torch.experiments.parallel_tier``'s
     checks, the launch counts reset before each parallel run and read
     after): ring attention (1, 32, 2048, 128) bf16 causal against K6
     within flash_fwd_tolerance; ring attention over 4 sequence shards in
     one process ((1, 32, 4096, 128) bf16 and (1, 4, 2048, 64) f32,
     causal), each rank's steps fed the shards in ring order, held to the
     plain version and to K6 over the whole sequence, with its K6 launches
     and times; the dp x tp step (1, 1), two bf16 steps equal to
     ``make_train_step``'s (rtol 1e-5), K6 and K7 once each a step, its
     host and kernel ms beside the single-device step's; the pipeline step
     with one stage and 4 microbatches, its loss the single-device step's
     on batch 4 within rtol 1e-3, K6 and K7 4 times each; the MoE layer
     with one expert (emb 4096, ffn 11008, 8192 tokens, bf16) against
     ``moe_apply_reference``, and one train step; the dp x tp MLP step
     (512-512-256-1, batch 2048, f32) equal to the plain step (rtol 1e-5).
     With two or more cards, ``experiments.parallel_tier`` under torchrun
     over all of them in f32, each path against the single-card result.
Timings (phases 2-4, 7-9, 11, 13, 14, 17, 19) use CUDA events after a warm-up and
report the median of several windows with the spread (min-max): the
kernel and the library call replayed from a CUDA graph (the card's time,
without the host's cost of issuing the calls; the kernel is also timed
issued eagerly from Python), the plain version issued eagerly.  Bounds: bytes over
3.35 TB/s, or operations over the H100's peak for the type (989 TF/s bf16,
67 TF/s f32, 165 TF/s for f32-accurate attention on the tensor cores).
Then a ``{"kernels": [...]}`` line (K6 and K7 by the path the main path
took; every launch of theirs in the 16-bit runs of phases 13 and 16 must
have been on wgmma, and in the f32 runs on tf32x3; K8a, K8b
and their one-rank copy by route, each with its own launches), and last
the ``{"ok": true, ...}`` line.
``--out PATH`` also writes the full results as JSON to PATH.
"""

from __future__ import annotations

import contextlib
import io
import itertools
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


def ring_across_cards(n: int, smi: str) -> dict:
    """K8a-d with one rank per card (shard r on cuda:r, peers reached by
    peer writes over NVLink) against their plain versions, every byte
    equal, at 1 MiB and 64 MiB f32 per rank; a planted fault must raise,
    and a ring whose peer card is still busy with earlier work must wait
    for it rather than run out of its bounded wait.  Timed eagerly on card
    0's stream (a CUDA graph captures one card's stream), median of 5
    windows; beside each, NCCL's call for the same function at the same
    per-rank shape in this process (``torch.cuda.nccl``, one communicator
    per card), timed the same way."""
    import torch
    import torch.cuda.nccl as nccl

    from param_tpu_torch.kernels import ring as k8
    from param_tpu_torch.utils.timer import time_samples

    devices = [torch.device("cuda", r) for r in range(n)]
    gen = torch.Generator().manual_seed(17)
    fns = {"all_gather": (k8.ring_all_gather_cuda, k8.ring_all_gather_plain),
           "reduce_scatter": (k8.ring_reduce_scatter_cuda,
                              k8.ring_reduce_scatter_plain),
           "bidir": (k8.ring_all_gather_bidir_cuda,
                     k8.ring_all_gather_bidir_plain),
           "loopback": (k8.ring_loopback_cuda, k8.ring_loopback_plain)}

    def library(coll, xs):
        """NCCL's collective computing the same function (the reduce-scatter
        leaves rank r chunk r, the ring chunk r + 1); None for the
        loopback, which no library call computes."""
        if coll == "loopback":
            return None
        if not nccl.is_available(xs):
            fail(f"torch.cuda.nccl cannot take the {n} shards")
        if coll == "reduce_scatter":
            outs = [torch.empty(x.numel() // n, device=x.device) for x in xs]
            call = lambda: nccl.reduce_scatter(xs, outs)  # noqa: E731
            want = torch.stack([x.cpu() for x in xs]).sum(0).chunk(n)
        else:
            outs = [torch.empty(n * x.numel(), device=x.device) for x in xs]
            call = lambda: nccl.all_gather(xs, outs)  # noqa: E731
            want = [torch.cat([x.cpu() for x in xs])] * n
        call()
        for r, (o, w) in enumerate(zip(outs, want)):
            if not torch.allclose(o.cpu(), w, rtol=1e-5, atol=1e-5):
                fail(f"NCCL {coll} across {n} cards: rank {r} is not the "
                     f"function the ring computes")
        return call

    rows = {}
    for coll, (cuda_fn, plain_fn) in fns.items():
        for mib in (1, 64):
            xs = [torch.randn((mib << 18,), generator=gen).to(d)
                  for d in devices]
            got, want = cuda_fn(xs), plain_fn(xs)
            for d in devices:
                torch.cuda.synchronize(d)
            for r, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                    fail(f"K8 {coll} across {n} cards, {mib} MiB: rank {r} "
                         f"differs from the plain version")
            iters = 5 if mib > 1 else 50
            t = time_samples(lambda: cuda_fn(xs, check=False), iters,
                             devices[0], reps=5)
            tp = time_samples(lambda: plain_fn(xs), 3, devices[0], reps=5)
            k8.check_errors(xs)
            lib = library(coll, xs)
            tl = time_samples(lib, iters, devices[0], reps=5) if lib else None
            for d in devices:
                torch.cuda.synchronize(d)
            # per card: its input read and output written over its HBM,
            # and what it sends one way over NVLink (450 GB/s each way)
            nb = mib << 20
            hbm, link = {"all_gather": (nb + n * nb, (n - 1) * nb),
                         "bidir": (nb + n * nb, (n // 2) * nb),
                         "reduce_scatter": (nb + nb // n,
                                            (n - 1) * nb // n),
                         "loopback": (2 * nb, 0)}[coll]
            b_ms, b_by = max((hbm / 3.35e9, "bytes"),
                             (link / 450e6, "NVLink bytes"))
            rec = dict(ms=statistics.median(t), min=min(t), max=max(t),
                       plain_ms=statistics.median(tp), bound_ms=b_ms,
                       bound_by=b_by, max_abs_err=0.0,
                       library_ms=statistics.median(tl) if tl else None,
                       library_min=min(tl) if tl else None,
                       library_max=max(tl) if tl else None)
            rows[f"{coll} n={n} {mib} MiB float32 cards"] = rec
            lib_text = "none" if tl is None else (
                f"{rec['library_ms']:.4f} ms ({rec['library_min']:.4f}-"
                f"{rec['library_max']:.4f})")
            say(f"phase 17 K8 {coll} across {n} cards (one rank per card), "
                f"{mib} MiB f32 per rank: every byte equal | kernel "
                f"{rec['ms']:.4f} ms ({rec['min']:.4f}-{rec['max']:.4f}, "
                f"issued eagerly) plain {rec['plain_ms']:.4f} ms NCCL "
                f"{lib_text} | bound {b_ms:.4f} ms ({b_by}, per card) | {smi}")
            del xs, got, want
    xs = [torch.randn((1 << 18,), generator=gen).to(d) for d in devices]
    try:
        k8.ring_all_gather_cuda(xs, fault=1, timeout_s=0.05)
    except RuntimeError as e:
        say(f"phase 17 K8 all_gather across {n} cards, planted fault: {e}")
    else:
        fail(f"K8 across {n} cards: the planted fault was not flagged")
    if not all(torch.equal(g, w) for g, w in zip(
            k8.ring_all_gather_cuda(xs), k8.ring_all_gather_plain(xs))):
        fail(f"K8 across {n} cards: wrong after the planted fault")
    # a peer card still busy: about 0.5 s of sleep queued on the last card
    # must hold every rank back, not run out a 0.2 s bounded wait
    for d in devices:
        torch.cuda.synchronize(d)
    with torch.cuda.device(devices[-1]):
        torch.cuda._sleep(10 ** 9)  # cycles: 0.5 s at 2 GHz or longer
    t0 = time.perf_counter()
    got = k8.ring_all_gather_cuda(xs, timeout_s=0.2)
    busy_s = time.perf_counter() - t0
    if busy_s < 0.3 or not all(torch.equal(g, w) for g, w in zip(
            got, k8.ring_all_gather_plain(xs))):
        fail(f"K8 across {n} cards behind a busy peer: {busy_s:.3f} s (the "
             f"queued work must outlast the 0.2 s wait), or a wrong result")
    say(f"phase 17 K8 all_gather across {n} cards behind about 0.5 s of "
        f"work queued on cuda:{n - 1}: the call took {busy_s:.3f} s, no "
        f"bounded wait (0.2 s) ran out, every byte equal")
    rows["busy peer"] = dict(seconds=busy_s)
    return rows


def comms_world(cards: int, smi: str) -> dict:
    """``cli.comms`` under torchrun, one rank per card on NCCL, every
    collective from 8 B to 64 MiB with dcheck, then all_reduce and
    all_gather from CUDA graphs, and pairwise pt2pt eagerly and from CUDA
    graphs; every row's dcheck must be OK."""
    from param_tpu_torch.backend import SUPPORTED_COLLECTIVES

    runs = {}
    for label, extra in (
            ("dispatch", ["--collective", ",".join(
                c for c in SUPPORTED_COLLECTIVES if c != "barrier"),
                "--b", "8", "--e", "64M", "--f", "8"]),
            ("graph", ["--collective", "all_reduce,all_gather,reduce_scatter",
                       "--b", "1K", "--e", "64M", "--f", "8", "--mode",
                       "graph"]),
            ("pairwise", ["--collective", "pt2pt", "--pt2pt", "pairwise",
                          "--b", "1K", "--e", "64M", "--f", "64"]),
            # each window one replayed CUDA graph, as the reference runs it
            # as one lax.scan program
            ("pairwise graph", ["--collective", "pt2pt", "--pt2pt",
                                "pairwise", "--b", "1K", "--e", "64M",
                                "--f", "64", "--mode", "graph"])):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(cards), "-m",
               "param_tpu_torch.cli.comms", "--", "--c", "1", *extra]
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True,
                             env=dict(os.environ, PYTHONPATH=ROOT))
        try:
            out = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            p.communicate()
            fail(f"phase 18 torchrun world of {cards} ({label}) timed out")
        rows = [ln for ln in out.splitlines()
                if re.match(r"\s+\d+[KMG]?\s+\d+\s", ln)]
        if p.returncode != 0 or not rows or any(
                not ln.endswith("  OK") for ln in rows):
            fail(f"phase 18 torchrun world of {cards} ({label}): rc "
                 f"{p.returncode}, dcheck not OK everywhere:\n{out[-6000:]}")
        wall = time.perf_counter() - t0
        say(f"phase 18 torchrun --nproc-per-node {cards} cli.comms "
            f"({label}) | {wall:.1f} s | {smi}\n{out.rstrip()}")
        runs[label] = dict(wall_s=wall, rows=len(rows), output=out)
    return runs


DLRM_OPTS = ("adagrad", "sparse_sgd", "sparse_adagrad")
_DLRM_ROW = re.compile(r"^\s*(\S+)\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)"
                       r"\s+([\d.]+)\s+([\d.]+)$", re.M)


def dlrm_bench_rows(out: str, what: str) -> dict:
    """The 21 reference rows of a DLRM-RES table and its QPS; fails unless
    every row is there, finite and positive."""
    from param_tpu_torch.models.dlrm_bench import REF_ROWS

    rows = {m.group(1): [float(v) for v in m.groups()[1:6]]
            for m in _DLRM_ROW.finditer(out)}
    names = [name for name, _, _ in REF_ROWS]
    qps = re.findall(r"^QPS: (\S+)$", out, re.M)
    bad = [k for k in names if k not in rows or not all(
        math.isfinite(v) and v > 0 for v in rows[k][1:])]
    if "DLRM-RES" not in out or bad or len(qps) != 1 or \
            not float(qps[0]) > 0:
        fail(f"phase 20 {what}: rows missing or not finite and positive "
             f"{bad}, QPS {qps}:\n{out}")
    return dict(rows={k: rows[k] for k in names}, qps=float(qps[0]))


def sharded_dlrm(smi: str, breakdown) -> dict:
    """Phase 20: the sharded DLRM in a world of one on NCCL, in-process,
    at the CLI's full default width (8 x 100,000 x 64 f32, batch 2048, nnz
    10, MLPs 512-256-64 / 512-256-1): two steps each of dense adagrad,
    sparse_sgd and sparse_adagrad against the single-device model on the
    card from the same parameters and batches (losses, every parameter and
    accumulator within rtol 1e-5, atol 1e-6); then ``cli.dlrm.main`` with
    no flags (the per-region bench, dense adagrad) and with ``--optimizer
    sparse_adagrad``, every one of the 21 reference rows finite and
    positive; then ``--print-comms``, the five entries of the step's
    pattern with the bench's payload bytes.  The launch counts are reset
    just before each sharded run and read just after: K1 must have
    launched on the sharded path, K2 in its sparse steps.  ``breakdown``
    (phase 13's) gives each step's host ms, kernel ms and busy share, the
    single-device model's beside the sharded one's."""
    import tempfile

    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.cli import dlrm as cli
    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
    from param_tpu_torch.models.dlrm_bench import DlrmCommBench
    from param_tpu_torch.models.dlrm_data import RandomDataset
    from param_tpu_torch.ops.mlp import make_optimizer, tree_leaves

    backend = DistBackend("cuda")
    backend.initialize()  # phase 18's world was shut down: a new one
    dev = backend.device
    cfg = DlrmConfig()
    single = DlrmModel(cfg, device=dev)
    sharded = DlrmModel(cfg, group=backend.get_default_group(), device=dev)
    batches = list(RandomDataset(batch=cfg.batch, dense_dim=cfg.dense_dim,
                                 num_tables=cfg.num_tables, nnz=cfg.nnz,
                                 num_rows=cfg.rows_per_table, num_batches=2,
                                 seed=11))
    launches = {k: 0 for k in kernels.launch_counts}

    def train(model, opt):
        params = model.init_params(0)
        acc, losses = None, []
        if opt == "sparse_sgd":
            step = model.make_sparse_sgd_step(0.01)
        elif opt == "sparse_adagrad":
            step = model.make_sparse_adagrad_step(0.01)
            acc = model.init_adagrad_state(params)
        else:
            optimizer = make_optimizer(opt, 0.01)
            step = model.make_train_step(optimizer)
            acc = optimizer.init(params)
        def again(b):
            return (step(params, *b) if opt == "sparse_sgd"
                    else step(params, acc, *b))[-1]

        for b in batches:
            losses.append(float(again(model.place_batch(b))))
        leaves = tree_leaves(params) + ([] if acc is None
                                        else tree_leaves(acc))
        return losses, [t.detach().clone() for t in leaves], again

    parity = {}
    for opt in DLRM_OPTS:
        want_losses, want, single_step = train(single, opt)
        kernels.reset_launch_counts()
        got_losses, got, sharded_step = train(sharded, opt)
        delta = dict(kernels.launch_counts)
        for k, v in delta.items():
            launches[k] += v
        if delta["emb_gather"] <= 0 or (opt.startswith("sparse") and delta[
                f"sparse_update_{opt[len('sparse_'):]}"] <= 0):
            fail(f"phase 20 sharded {opt}: K1 / K2 not launched ({delta})")
        err = max(abs(a - b) for a, b in zip(got_losses, want_losses))
        if not all(math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-6)
                   for a, b in zip(got_losses, want_losses)):
            fail(f"phase 20 sharded {opt}: losses {got_losses} against the "
                 f"single-device model's {want_losses}")
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            err = max(err, (g - w).abs().max().item())
            if not torch.allclose(g, w, rtol=1e-5, atol=1e-6):
                fail(f"phase 20 sharded {opt}: leaf {i} of the parameters "
                     f"and accumulators differs from the single-device "
                     f"model's by {(g - w).abs().max().item():.3e}")
        b1, bn = single.place_batch(batches[0]), sharded.place_batch(
            batches[0])
        parity[opt] = dict(
            losses=got_losses, max_abs_err=err,
            launches={k: v for k, v in delta.items() if v},
            single=breakdown(f"single-device step {opt}",
                             lambda: single_step(b1), grad=True, phase=20),
            sharded=breakdown(f"sharded step {opt} (world 1)",
                              lambda: sharded_step(bn), grad=True, phase=20))
        say(f"phase 20 sharded DLRM (world 1, NCCL) {opt}: 2 steps at full "
            f"width, losses {got_losses} equal the single-device model's "
            f"within rtol 1e-5, atol 1e-6; every parameter and accumulator "
            f"too, max abs err {err:.3e} | launches {parity[opt]['launches']}")
        del want, got, single_step, sharded_step
        torch.cuda.empty_cache()

    runs = {}
    for label, argv, k2 in (("default", [], None),
                            ("sparse_adagrad",
                             ["--optimizer", "sparse_adagrad"],
                             "sparse_update_adagrad")):
        buf = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--log", "WARNING"])
        wall = time.perf_counter() - t0
        delta = dict(kernels.launch_counts)
        for k, v in delta.items():
            launches[k] += v
        out = buf.getvalue()
        if rc != 0 or delta["emb_gather"] <= 0 or (k2 and delta[k2] <= 0):
            fail(f"phase 20 cli.dlrm {' '.join(argv)}: rc {rc}, K1 / K2 not "
                 f"launched ({delta}):\n{out}")
        runs[label] = dict(dlrm_bench_rows(out, f"cli.dlrm {label}"),
                           argv=argv, wall_s=wall, output=out,
                           launches={k: v for k, v in delta.items() if v})
        say(f"phase 20 cli.dlrm {' '.join(argv) or '(no flags)'}: per-region "
            f"bench, world 1 on NCCL, full width | {wall:.1f} s | launches "
            f"{runs[label]['launches']} | {smi}\n{out.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "comms.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--print-comms", path, "--log", "WARNING"])
        with open(path) as f:
            pattern = json.load(f)
    mem = DlrmCommBench(sharded, "sparse_sgd").region_memory_bytes()
    want = [("all_to_all", "idx_xchg"), ("all_to_all", "fwd_a2a"),
            ("all_reduce", "bwd_top_ar(iso)"), ("all_to_all", "bwd_a2a(iso)"),
            ("all_reduce", "bwd_bot_ar(iso)")]
    if rc != 0 or len(pattern) != 5 or any(
            e["comms"] != c or e["in_msg_size"] * 4 != mem[k]
            or e["world_size"] != 1 for e, (c, k) in zip(pattern, want)):
        fail(f"phase 20 --print-comms: rc {rc}, pattern {pattern} against "
             f"the payload bytes {mem}")
    say(f"phase 20 cli.dlrm --print-comms: {len(pattern)} entries "
        f"({', '.join(e['markers'][0] for e in pattern)}) with the bench's "
        f"payload bytes")
    backend.shutdown()
    del single, sharded
    torch.cuda.empty_cache()
    return dict(parity=parity, bench=runs, pattern=pattern,
                launches={k: v for k, v in launches.items() if v})


def dlrm_world(cards: int, smi: str, first_losses=None) -> dict:
    """``cli.dlrm`` under torchrun, one rank per card on NCCL:
    ``--train-batches 5`` for each optimizer, whose first loss (rank 0's,
    the global batch's) must equal ``first_losses[opt]`` of a world of one
    within rtol 1e-5 (and 1e-5, the printed loss's resolution), then the
    default per-region bench.  Without ``first_losses`` the world of one
    (the single-device trainer) runs here first."""
    if first_losses is None:
        from param_tpu_torch.cli import dlrm as cli

        first_losses = {}
        for opt in DLRM_OPTS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--train-batches", "5", "--optimizer", opt,
                               "--log", "WARNING"])
            losses = re.findall(r"loss (\S+)", buf.getvalue())
            if rc != 0 or not losses:
                fail(f"phase 20 world of one {opt}:\n{buf.getvalue()}")
            first_losses[opt] = float(losses[0])
            say(f"phase 20 world of one {opt}:\n{buf.getvalue().strip()}")
    runs = {}
    for label, argv in [(opt, ["--train-batches", "5", "--optimizer", opt])
                        for opt in DLRM_OPTS] + [("bench", [])]:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(cards), "-m",
               "param_tpu_torch.cli.dlrm", "--", *argv, "--log", "WARNING"]
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True,
                             env=dict(os.environ, PYTHONPATH=ROOT))
        try:
            out = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            p.communicate()
            fail(f"phase 20 torchrun world of {cards} ({label}) timed out")
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            fail(f"phase 20 torchrun world of {cards} ({label}): rc "
                 f"{p.returncode}:\n{out[-6000:]}")
        if label == "bench":
            rec = dlrm_bench_rows(out, f"torchrun world of {cards} bench")
            if f"DLRM-RES world={cards} " not in out:
                fail(f"phase 20 torchrun bench: not a world of {cards}")
        else:
            losses = [float(x) for x in re.findall(r"loss (\S+)", out)]
            e2e = [ln for ln in out.splitlines() if ln.startswith("DLRM-E2E")]
            if len(losses) != 5 or len(e2e) != 1 or \
                    f"world={cards}" not in e2e[0]:
                fail(f"phase 20 torchrun {label}: output:\n{out[-6000:]}")
            if not math.isclose(losses[0], first_losses[label],
                                rel_tol=1e-5, abs_tol=1e-5):
                fail(f"phase 20 torchrun world of {cards} {label}: first "
                     f"loss {losses[0]} against a world of one's "
                     f"{first_losses[label]}")
            fields = dict(re.findall(r"(\w[\w-]*)=(\S+)", e2e[0]))
            rec = dict(losses=losses, step_ms=float(fields["step_ms"]),
                       qps=float(fields["QPS"]))
        rec.update(wall_s=wall, output=out)
        runs[label] = rec
        say(f"phase 20 torchrun --nproc-per-node {cards} cli.dlrm "
            f"{' '.join(argv) or '(no flags)'} | {wall:.1f} s | {smi}\n"
            f"{out.strip()}")
    return runs


LLAMA2 = dict(seq=2048, emb=4096, heads=32, ffn=11008)


def ring_shards(shape, dtype, causal, smi, dev, breakdown) -> dict:
    """Ring attention over 4 sequence shards on one card, in one process:
    for each rank r in turn, ``ring_attention_steps`` fed the shards in
    ring order (what r would hold at each step), the 4 outputs
    concatenated and held to the plain version and to K6 over the whole
    sequence.  f32: within atol = rtol = 3e-5 of the plain version (the
    reference's ring tolerance).  16-bit, with u the unit roundoff: each
    partial output is rounded once by K6 within its own flash bound,
    u (2 |O_t| + |P_t| @ |V|); the merge weights sum these to at most
    3 u |P| @ |V|, and the final cast adds u |O|; with flash_fwd_tolerance's
    2^-6 margin and 2^-16 for the f32 sums.  Against K6 the bound is that
    one plus K6's own.  Also times the 4 ranks' steps one after another
    beside one K6 call over the whole sequence (eager, CUDA events), and
    ``breakdown`` (phase 13's) splits the 4 ranks' steps by kernel."""
    import torch

    from param_tpu_torch import kernels
    from param_tpu_torch.kernels.flash_fwd import (
        flash_fwd_plain, flash_fwd_tolerance,
    )
    from param_tpu_torch.ops.attention import flash_attention
    from param_tpu_torch.ops.ring_attention import ring_attention_steps
    from param_tpu_torch.utils.timer import time_samples

    n = 4
    b, h, s, d = shape
    sl = s // n
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 0.3)
               .to(dtype) for _ in range(3))
    ks = [k[:, :, i * sl:(i + 1) * sl] for i in range(n)]
    vs = [v[:, :, i * sl:(i + 1) * sl] for i in range(n)]

    def ring():
        return torch.cat([ring_attention_steps(
            q[:, :, r * sl:(r + 1) * sl],
            ((ks[(r - t) % n], vs[(r - t) % n]) for t in range(n)), r, n,
            causal=causal) for r in range(n)], dim=2)

    kernels.reset_launch_counts()
    got = ring()
    torch.cuda.synchronize()
    launches = kernels.launch_counts["flash_fwd"]
    whole = flash_attention(q, k, v, causal=causal)
    want = flash_fwd_plain(q, k, v, causal)
    if dtype == torch.float32:
        bound = 3e-5 + 3e-5 * want.abs()
        k6_bound = 2e-5
    else:
        u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -11
        pv = flash_fwd_plain(q, k, v.abs(), causal).float()
        bound = (1 + 2.0 ** -6) * u * (want.float().abs() + 3 * pv) + 2.0 ** -16
        k6_bound = flash_fwd_tolerance(q, k, v, want, causal)
    err = (got.float() - want.float()).abs()
    err_k6 = (got.float() - whole.float()).abs()
    if not (err <= bound).all() or not (err_k6 <= bound + k6_bound).all():
        fail(f"phase 21 ring attention {shape} {dtype} over {n} in-process "
             f"shards: max error {err.max().item():.3e} against the plain "
             f"version, {err_k6.max().item():.3e} against K6 over the whole "
             f"sequence, over their bounds")
    ring_ms = statistics.median(time_samples(ring, 5, dev, reps=5))
    k6_ms = statistics.median(time_samples(
        lambda: flash_attention(q, k, v, causal=causal), 5, dev, reps=5))
    rec = dict(shape=list(shape), dtype=str(dtype), k6_launches=launches,
               max_abs_err=err.max().item(),
               max_abs_err_k6=err_k6.max().item(), ring_ms=ring_ms,
               k6_whole_ms=k6_ms, breakdown=breakdown(
                   f"ring attention {shape} {dtype} over {n} in-process "
                   f"shards", ring, 10, phase=21))
    say(f"phase 21 ring attention {shape} {dtype} causal over {n} "
        f"in-process shards: K6 launches {launches}, max abs err "
        f"{rec['max_abs_err']:.3e} (plain) / {rec['max_abs_err_k6']:.3e} "
        f"(K6 whole) | the 4 ranks' steps {ring_ms:.4f} ms against K6 over "
        f"the whole sequence {k6_ms:.4f} ms (eager, CUDA events) | {smi}")
    return rec


def parallel_tier(smi: str, breakdown) -> dict:
    """Phase 21: the multi-device transformer tier in a world of one on
    NCCL at llama2-7B width (``experiments.parallel_tier``'s checks; the
    launch counts reset just before each parallel run and read just
    after): ring attention (1, 32, 2048, 128) bf16 causal against K6's
    ``flash_attention`` within flash_fwd_tolerance, then over 4 in-process
    shards (:func:`ring_shards`); the dp x tp step at (1, 1), two steps
    equal to ``make_train_step``'s (losses and every parameter within rtol
    1e-5), K6 and K7 once each a step; the pipeline step with one stage
    and 4 microbatches of 1, its loss the single-device step's on batch 4
    within rtol 1e-3, K6 and K7 4 times each; ``moe_apply_ep`` (emb 4096,
    ffn 11008, 8192 tokens, bf16, one expert) against
    ``moe_apply_reference`` within 4 bf16 ulps of the largest output, then
    one train step, its loss finite and within rtol 1e-3 of the oracle's;
    the dp x tp MLP step (512-512-256-1, batch 2048, f32) equal to the
    plain step within rtol 1e-5.  ``breakdown`` (phase 13's) gives the tp
    step's host and kernel ms beside the single-device step's."""
    import torch

    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.experiments import parallel_tier as par
    from param_tpu_torch.kernels.flash_fwd import flash_fwd_tolerance
    from param_tpu_torch.models import moe
    from param_tpu_torch.models import transformer as tfm
    from param_tpu_torch.models.parallel import mesh_groups

    backend = DistBackend("cuda")
    backend.initialize()  # phase 20's world was shut down: a new one
    dev = backend.device
    group = backend.get_default_group()
    bf16 = torch.bfloat16
    res = {}

    def show(label, rec, extra=""):
        errs = ", ".join(f"{k} {v:.3e}" for k, v in rec.items()
                         if k.startswith("max_"))
        say(f"phase 21 {label}: {rec['wall_s']:.3f} s | launches "
            f"{rec['launches']} | {errs}{extra} | steady {rec['ms']:.4f} ms "
            f"a call (single-device oracle {rec['oracle_ms']:.4f}) | {smi}")

    def launched(label, rec, fwd, bwd):
        got = (rec["launches"].get("flash_fwd", 0),
               rec["launches"].get("flash_bwd", 0))
        if got != (fwd, bwd):
            fail(f"phase 21 {label}: K6 / K7 launched {got} times, not "
                 f"({fwd}, {bwd}): {rec['launches']}")

    res["ring_world1"] = par.check_ring(
        group, (1, 32, 2048, 128), bf16, dev,
        tol=lambda q, k, v, want, causal: flash_fwd_tolerance(
            q, k, v, want, causal))
    launched("ring attention, world 1", res["ring_world1"], 1, 0)
    show("ring attention (1, 32, 2048, 128) bf16 causal, world 1, against "
         "K6's flash_attention", res["ring_world1"])
    res["ring_shards"] = [ring_shards((1, 32, 4096, 128), bf16, True, smi,
                                      dev, breakdown),
                          ring_shards((1, 4, 2048, 64), torch.float32, True,
                                      smi, dev, breakdown)]
    torch.cuda.empty_cache()

    cfg = tfm.TransformerConfig(batch=1, **LLAMA2)
    rec = par.check_tp(backend, 1, 1, cfg, dev, steps=2, loss_rtol=1e-5,
                       param_rtol=1e-5)
    launched("tp step (1, 1)", rec, 2, 2)
    show("dp x tp step (1, 1) at llama2 width bf16, 2 steps against "
         "make_train_step", rec, f" | losses {rec['losses']}")
    groups = mesh_groups(backend, 1, 1)
    x = (torch.randn((1, cfg.seq, cfg.emb), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev) * 0.1).bfloat16()
    full = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    for label, step, p in (
            ("single-device step", tfm.make_train_step(cfg), full),
            ("tp step (1, 1)", tfm.make_sharded_train_step(groups, cfg),
             tfm.tp_shard(full, cfg, 0, 1))):
        state = {"p": p}

        def train(state=state, step=step):
            state["p"], loss = step(state["p"], x)
            return loss

        rec[f"breakdown {label}"] = breakdown(
            f"{label} (1, 2048, 4096, 32, 11008) bf16", train, 10, grad=True,
            phase=21)
        del state
    res["tp_world1"] = rec
    del full, x
    torch.cuda.empty_cache()

    rec = par.check_pp(group, tfm.TransformerConfig(batch=4, **LLAMA2), 4,
                       dev, loss_rtol=1e-3)
    launched("pp step, one stage", rec, 4, 4)
    show("pp step, one stage, 4 microbatches of 1 at llama2 width bf16, "
         "against the single-device step on batch 4", rec,
         f" | loss {rec['loss']} (oracle {rec['oracle_loss']})")
    res["pp_world1"] = rec
    torch.cuda.empty_cache()

    rec = par.check_moe(
        group, moe.MoeConfig(4096, 11008, 1, dtype="bfloat16"), 8192, dev,
        out_tol=lambda want: 4 * 2.0 ** -8 * want.float().abs().max(),
        loss_rtol=1e-3)
    show("MoE, one expert (emb 4096, ffn 11008, 8192 tokens, bf16), "
         "moe_apply_ep against moe_apply_reference, then one train step",
         rec, f" | step loss {rec['loss']} (oracle {rec['oracle_loss']})")
    res["moe_world1"] = rec
    torch.cuda.empty_cache()

    rec = par.check_mlp(backend, 1, 1, [512, 512, 256, 1], 2048, dev,
                        rtol=1e-5, param_rtol=1e-5)
    show("dp x tp MLP step (1, 1), 512-512-256-1, batch 2048, f32, against "
         "the plain step", rec, f" | loss {rec['loss']}")
    res["mlp_world1"] = rec
    backend.shutdown()
    torch.cuda.empty_cache()
    return res


def parallel_world(cards: int, smi: str) -> dict:
    """``experiments.parallel_tier`` under torchrun, one rank per card on
    NCCL, in f32: ring attention over the cards, tp at (cards / 2, 2) and
    (1, cards), pp over the cards, MoE with one expert a card, the MLP at
    (cards / 2, 2), each held to the single-card result on the same inputs
    (loss rtol 1e-4; the largest parameter error printed)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(cards), "-m",
           "param_tpu_torch.experiments.parallel_tier"]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        out = p.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        p.communicate()
        fail(f"phase 21 torchrun world of {cards} timed out")
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if p.returncode != 0 or not lines:
        fail(f"phase 21 torchrun world of {cards}: rc {p.returncode}:\n"
             f"{out[-6000:]}")
    res = json.loads(lines[-1])
    for key, rec in res.items():
        if not isinstance(rec, dict):
            continue
        want = ({"flash_fwd"} if key == "ring" else
                {"flash_fwd", "flash_bwd"} if key.startswith(("tp", "pp"))
                else set())
        if not want <= set(rec["launches"]):
            fail(f"phase 21 torchrun {key}: {want} not launched "
                 f"({rec['launches']})")
        errs = ", ".join(f"{k} {v:.3e}" for k, v in rec.items()
                         if k.startswith("max_"))
        say(f"phase 21 torchrun world of {cards} {key}: {rec['wall_s']:.3f} s "
            f"(rank 0) | launches (rank 0) {rec['launches']} | {errs} | "
            f"steady {rec['ms']:.4f} ms a call on {cards} cards, the "
            f"single-card oracle {rec['oracle_ms']:.4f} (rank 0) | {smi}")
    res["wall_s"] = wall
    return res


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
    resources = {n: build.kernel_resources(n) for n in build.SOURCES}
    reg_counts = {n: [r.get("registers") for r in k.values()]
                  for n, k in resources.items()}
    spills = {n: [r.get("spill_stores") for r in k.values()]
              for n, k in resources.items()}
    say(f"phase 1 device: {kind} | nvidia-smi: {smi} | "
        f"capability {torch.cuda.get_device_capability(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{build_s:.1f} s | ptxas registers per kernel {reg_counts} | "
        f"spill-store bytes per kernel {spills}")
    flash_res = {}
    for lib in ("flash_fwd", "flash_bwd"):
        for mangled, res in resources[lib].items():
            m = re.search(r"flash_(?:fwd|bwd_dq|bwd_dkv)_(?:wgmma|tc|tf32x3)",
                          mangled)
            dims = re.search(r"Li(\d+)E", mangled)
            dt = ("bf16" if "bfloat16" in mangled else
                  "f16" if "__half" in mangled else "f32")
            label = (f"{m.group(0) if m else mangled}<{dt}, "
                     f"D={dims.group(1) if dims else '?'}>")
            flash_res[label] = res
    say("phase 1 K6 / K7 kernels (ptxas; wgmma kernels at launch, before "
        "setmaxnreg): " + "; ".join(
            f"{label} {r.get('registers')} registers, "
            f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes spilled "
            f"(stores / loads)" for label, r in sorted(flash_res.items())))
    result["phases"]["device"] = dict(smi=smi, kind=kind, build_s=build_s,
                                      registers=reg_counts, spills=spills,
                                      flash_kernels=flash_res)

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
        n_k, n_p = itertools.cycle(idx_list), itertools.cycle(idx_list)
        n_l = itertools.cycle([i.long() for i in idx_list])
        rec = timings(lambda: emb_gather_cuda(table, next(n_k)),
                      lambda: emb_gather_plain(table, next(n_p)),
                      lambda: F.embedding_bag(next(n_l), table, mode="sum"),
                      iters)
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
        gemm_cuda, gemm_plain, gemm_schedule, gemm_wres_cuda, gemm_wres_plain,
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

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def with_path(fn):
        """fn() and the 16-bit path whose launch counter it moved (simt when
        neither moved)."""
        keys = ("gemm_wgmma", "gemm_mma_sync")
        before = [kernels.launch_counts[k] for k in keys]
        out = fn()
        moved = [k[5:] for k, b0 in zip(keys, before)
                 if kernels.launch_counts[k] != b0]
        return out, moved[0] if moved else "simt"

    k3 = {}
    for dt, shapes in ((torch.bfloat16, [(1024, 4096, 4096), (4096, 4096, 128),
                                         (128, 1024, 1024), (1024, 1024, 128),
                                         (100, 100, 100)]),
                       (torch.float16, [(1024, 4096, 4096)]),
                       (torch.float32, [(1024, 4096, 4096), (4096, 4096, 128),
                                        (128, 1024, 1024), (1024, 1024, 4096),
                                        (100, 100, 100)])):
        for m, n, k in shapes:
            a = torch.randn((m, k), generator=gen, device=dev).to(dt)
            b = torch.randn((k, n), generator=gen, device=dev).to(dt)
            want = gemm_plain(a, b)
            name = f"{str(dt)[6:]} {(m, n, k)}"
            got, path = with_path(lambda: gemm_cuda(a, b))
            err = check(f"K3 {name}", got, want, gemm_tol(want))
            vec = 16 // a.element_size()
            aligned = k % vec == 0 and n % vec == 0
            splits = gemm_schedule(m, n, k, dt, aligned, sms)[2]
            if dt != torch.float32 and aligned and path != "wgmma":
                fail(f"K3 {name}: an aligned 16-bit shape ran {path}, not "
                     f"wgmma")
            es = a.element_size()
            b_ms, b_by = bound_ms((m * k + k * n + m * n) * es, 2 * m * n * k,
                                  fp32=dt == torch.float32)
            rec = timings(lambda: gemm_cuda(a, b), lambda: gemm_plain(a, b),
                          lambda: torch.matmul(a, b), 20)
            rec.update(shape=f"({m}, {k}) @ ({k}, {n}) {str(dt)[6:]}",
                       max_abs_err=err, tol=gemm_tol(want), bound_ms=b_ms,
                       bound_by=b_by, tflops=2 * m * n * k / rec["ms"] / 1e9,
                       path=path, splits=splits)
            if name == "bfloat16 (1024, 4096, 4096)":
                # planted fault: negate B's largest element after the plain
                # call; the kernel's output must then break the tolerance
                flat = b.view(-1)
                i = int(flat.abs().argmax())
                flat[i] = -flat[i]
                bad, _ = with_path(lambda: gemm_cuda(a, b))
                torch.cuda.synchronize()
                flat[i] = -flat[i]
                fault = (bad.float() - want.float()).abs().max().item()
                if not fault > rec["tol"]:
                    fail(f"K3 {name}: the planted fault (B element {i} "
                         f"negated) was not flagged: err {fault:.3e} <= tol "
                         f"{rec['tol']:.3e}")
                rec["fault_err"] = fault
                say(f"phase 7 K3 {name} planted fault (B element {i} "
                    f"negated): max_abs_err {fault:.3e} > tol "
                    f"{rec['tol']:.3e}, flagged")
                del bad
            k3[name] = rec
            say(f"phase 7 K3 {rec['shape']}: path {path}, {splits} K "
                f"split(s) | max_abs_err {err:.3e} (tol "
                f"{rec['tol']:.3e}) | {timing_text(rec, 'torch.matmul')} "
                f"({rec['tflops']:.1f} TF/s) bound {b_ms:.4f} ms ({b_by}) | "
                f"{smi}")
            del a, b, want, got
    result["phases"]["k3"] = k3

    # ---------------------------------------------------------------- 8
    S, m, k, n = 8, 128, 4096, 4096
    a = torch.randn((S, m, k), generator=gen, device=dev).bfloat16()
    b = torch.randn((k, n), generator=gen, device=dev).bfloat16()
    want = gemm_wres_plain(a, b)
    got, path = with_path(lambda: gemm_wres_cuda(a, b))
    err = check("K4", got, want, gemm_tol(want))
    if path != "wgmma":
        fail(f"K4: the stacked bf16 GEMM ran {path}, not wgmma")
    a2 = a.reshape(S * m, k)
    b_ms, b_by = bound_ms((S * m * k + k * n + S * m * n) * 2,
                          S * 2 * m * n * k, fp32=False)
    k4 = timings(lambda: gemm_wres_cuda(a, b), lambda: gemm_wres_plain(a, b),
                 lambda: torch.matmul(a2, b), 20)
    k4.update(shape=f"S={S} x ({m}, {k}) @ ({k}, {n}) bf16", max_abs_err=err,
              tol=gemm_tol(want), bound_ms=b_ms, bound_by=b_by,
              per_gemm_ms=k4["ms"] / S,
              tflops=S * 2 * m * n * k / k4["ms"] / 1e9, path=path,
              splits=gemm_schedule(S * m, n, k, torch.bfloat16, True, sms)[2])
    say(f"phase 8 K4 {k4['shape']}: path {path}, {k4['splits']} K split(s) "
        f"| max_abs_err {err:.3e} (tol "
        f"{k4['tol']:.3e}) | {timing_text(k4, 'torch.matmul (stacked A)')} "
        f"| per GEMM {k4['per_gemm_ms']:.4f} ms ({k4['tflops']:.1f} TF/s) "
        f"bound {b_ms:.4f} ms ({b_by}) | {smi}")
    result["phases"]["k4"] = k4
    del a, b, a2, want, got

    # ---------------------------------------------------------------- 9
    import param_tpu_torch.kernels.int4_gemm as k5mod
    from torch.autograd import DeviceType

    k5 = {}
    G = 128
    k5_res = build.kernel_resources("int4_gemm")
    # the bf16-output kernel(s) of each K5 path, as ptxas names them
    K5_KERNELS = {"stream": r"st18int4_stream_kernelI13__nv_bfloat16",
                  "stream wgmma": r"int4_stream_wgmma_kernelILi(16|32)E13",
                  "wgmma": r"wq17int4_wgmma_kernelI13__nv_bfloat16",
                  "mma_sync": r"int4_mma_kernelILb1E|splitk_reduce_kernelI13"}

    def k5_resources(path, m):
        key = "stream wgmma" if path == "stream" and m > 8 else path
        out = {}
        for name, res in k5_res.items():
            if re.search(K5_KERNELS[key], name):
                label = re.search(r"int4_(stream_wgmma|stream|wgmma|mma)"
                                  r"_kernel|splitk_reduce_kernel",
                                  name).group(0)
                rows = re.search(r"kernelILi(\d+)E", name)
                out[label + (f"<{rows.group(1)}>" if rows else "")] = res
        return out

    def profiled_kernels(run):
        """Kernel ms per call of ``run`` from torch.profiler (10 calls after
        3 warm-ups), and its largest kernels."""
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                    ev.self_device_time_total / 1e3 / 10
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        return dict(ms=sum(by_name.values()),
                    kernels=[f"{nm[:60]} {ms:.4f} ms" for nm, ms in top])

    def k5_path(x, packed, scale):
        """The path (and K splits) K5 takes for these tensors."""
        (m, k), (kh, n) = x.shape, packed.shape
        aligned = (n % 16 == 0 and k % 8 == 0 and x.data_ptr() % 16 == 0
                   and packed.data_ptr() % 16 == 0
                   and scale.data_ptr() % 16 == 0)
        return k5mod.int4_schedule(m, n, kh, kh // scale.shape[0], aligned,
                                   sms)

    def int4pack_library(x, packed, scale, want):
        """torch._weight_int4pack_mm on K5's weights: signed nibble q as
        the unsigned q + 8 with zero point 0, (K/g, N, 2) bf16 scales and
        zeros.  Returns (callable, note), or (None, why not) where the call
        refuses the shape or does not compute the same function."""
        k, n = 2 * packed.shape[0], packed.shape[1]
        p = packed.to(torch.int32)
        q = torch.empty((k, n), dtype=torch.int32, device=dev)
        q[0::2] = (p & 15) - 8
        q[1::2] = p >> 4
        u = (q + 8).t().contiguous()  # (N, K) in [0, 15]
        w8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
        sz = torch.stack([scale, torch.zeros_like(scale)], dim=2) \
            .to(torch.bfloat16).contiguous()
        try:
            wp = torch._convert_weight_to_int4pack(w8, 8)
            got = torch._weight_int4pack_mm(x, wp, G, sz)
            torch.cuda.synchronize()
        except RuntimeError as e:  # the yardstick refuses; K5 is unaffected
            return None, f"none: torch._weight_int4pack_mm refused ({e})"[:200]
        err = (got.float() - want).abs().max().item()
        if not err <= 1e-2 * want.abs().max().item():
            return None, (f"none: torch._weight_int4pack_mm differs by "
                          f"{err:.3e}")
        return (lambda: torch._weight_int4pack_mm(x, wp, G, sz),
                "torch._weight_int4pack_mm")

    def k5_case(m, k, n, phase, fault=False):
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen,
                               device=dev, dtype=torch.int32).to(torch.int8)
        # bf16-exact scales, so the library call's bf16 scales are K5's
        scale = (torch.rand((k // G, n), generator=gen, device=dev)
                 * 0.02).bfloat16().float()
        want = int4_gemm_plain(x, packed, scale, torch.float32)
        tol = 1e-5 * want.abs().max().item()
        # the bf16-output kernels (the main path's) against the plain
        # version rounded to bf16: one bf16 ulp of max |want|
        want16 = int4_gemm_plain(x, packed, scale)
        tol16 = 2.0 ** -7 * want.abs().max().item()
        path, _, splits = k5_path(x, packed, scale)
        if m <= 32 and path != "stream" or m == 512 and path != "wgmma":
            fail(f"K5 {(m, k, n)}: took {path}, not its designed path")

        def held(label, run):
            """The f32- and bf16-output kernels of ``run``'s path against
            the plain version, each twice (bitwise repeat); returns the
            f32 error and the bf16 one, and the counters that moved."""
            before = dict(kernels.launch_counts)
            got, again = run(torch.float32), run(torch.float32)
            got16, again16 = run(torch.bfloat16), run(torch.bfloat16)
            moved = {c: v - before[c] for c, v in
                     kernels.launch_counts.items() if v != before[c]}
            err = check(f"K5 {(m, k, n)} {label}", got, want, tol)
            err16 = check(f"K5 {(m, k, n)} {label} bf16 out", got16, want16,
                          tol16)
            if not (torch.equal(got, again) and torch.equal(got16, again16)):
                fail(f"K5 {(m, k, n)} ({label}): two runs differ")
            return err, err16, moved

        err, err16, moved = held(
            path, lambda od: int4_gemm_cuda(x, packed, scale, od))
        if moved != {"int4_gemm": 4, f"int4_gemm_{path}": 4}:
            fail(f"K5 {(m, k, n)}: launches moved {moved}, not 4 on {path}")
        # the parent's design (mma_sync + its reduce kernel), still the
        # path of unaligned products, held to the same tolerances
        with k5mod.forced_path("mma_sync"):
            err_p, err16_p, moved_p = held(
                "mma_sync", lambda od: int4_gemm_cuda(x, packed, scale, od))
        if moved_p != {"int4_gemm": 4, "int4_gemm_mma_sync": 4}:
            fail(f"K5 {(m, k, n)}: the mma_sync design moved {moved_p}, "
                 f"not 4 launches on mma_sync")
        nbytes = k * n // 2 + (k // G) * n * 4 + m * k * 2 + m * n * 2
        b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, fp32=False)
        w_bf16 = int4_dequant(packed, scale).bfloat16()
        lib, lib_note = int4pack_library(x, packed, scale, want)
        iters = 50 if m <= 32 else 10
        kernel = lambda: int4_gemm_cuda(x, packed, scale)  # noqa: E731
        rec = timings(kernel, lambda: int4_gemm_plain(x, packed, scale), lib,
                      iters)
        rec["library_note"] = lib_note
        rec["dequant_matmul"] = timed(lambda: torch.matmul(x, w_bf16), 50)
        prof = profiled_kernels(kernel)
        # the parent's design in this run
        with k5mod.forced_path("mma_sync"):
            rec["t_parent"] = timed(kernel, iters)
            rec["t_parent_eager"] = timed(kernel, iters, graph=False)
            prof_parent = profiled_kernels(kernel)
        rec.update(shape=f"({m}, {k}) @ int4 ({k}, {n}) g={G}, bf16 out",
                   max_abs_err=err, tol=tol, max_abs_err_bf16=err16,
                   tol_bf16=tol16, parent_max_abs_err=err_p,
                   parent_max_abs_err_bf16=err16_p, bound_ms=b_ms,
                   bound_by=b_by, gbps=nbytes / rec["ms"] / 1e6, path=path,
                   splits=splits, parent_ms=rec["t_parent"]["ms"],
                   profile=prof, profile_parent=prof_parent,
                   bitwise_repeat=True, ptxas=k5_resources(path, m))
        if fault:
            # planted fault: change one packed byte (the pair of rows with
            # the largest |x|) after the plain call; the kernel's output
            # must then break the tolerance
            i = int((x[0, 0::2].float().abs() + x[0, 1::2].float().abs())
                    .argmax())
            packed[i, 0] ^= 0x77
            bad = int4_gemm_cuda(x, packed, scale, torch.float32)
            torch.cuda.synchronize()
            packed[i, 0] ^= 0x77
            fault_err = (bad - want).abs().max().item()
            if not fault_err > tol:
                fail(f"K5 {(m, k, n)}: the planted fault (packed byte ({i}, "
                     f"0) changed) was not flagged: err {fault_err:.3e} <= "
                     f"tol {tol:.3e}")
            rec["fault_err"] = fault_err
            say(f"phase {phase} K5 {rec['shape']} planted fault (packed byte "
                f"({i}, 0) changed): max_abs_err {fault_err:.3e} > tol "
                f"{tol:.3e}, flagged")
        k5[f"{(m, k, n)}"] = rec
        say(f"phase {phase} K5 {rec['shape']}: path {path}, {splits} K "
            f"split(s), bitwise repeatable | max_abs_err {err:.3e} (tol "
            f"{tol:.3e}), bf16 out {err16:.3e} (tol {tol16:.3e}); mma_sync "
            f"design {err_p:.3e}, bf16 out {err16_p:.3e}, bitwise repeatable "
            f"| {timing_text(rec, lib_note)}"
            f"{'' if lib else f' ({lib_note})'} "
            f"({rec['gbps']:.0f} GB/s) bound {b_ms:.4f} ms ({b_by}) | "
            f"parent design (mma_sync + reduce) {fmt(rec['t_parent'])} "
            f"[issued eagerly {fmt(rec['t_parent_eager'])}] | profiler: "
            f"{'; '.join(prof['kernels'])} (parent: "
            f"{'; '.join(prof_parent['kernels'])}) | ptxas "
            + "; ".join(f"{nm} {r.get('registers')} registers, "
                        f"{r.get('spill_stores')} / {r.get('spill_loads')} "
                        f"bytes spilled" for nm, r in rec["ptxas"].items())
            + f" | not the same function: torch.matmul on the dequantized "
            f"bf16 weight {fmt(rec['dequant_matmul'])} | {smi}")

    for m, k, n in [(mm, kk, nn) for mm in (1, 8, 32)
                    for kk, nn in ((4096, 11008), (11008, 4096))] + \
            [(512, 4096, 4096)]:
        k5_case(m, k, n, 9, fault=(m, k, n) in ((1, 4096, 11008),
                                                (512, 4096, 4096)))
    result["phases"]["k5"] = k5
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 10
    from param_tpu_torch.cli import compute as compute_cli
    from param_tpu_torch.cli import inference as inference_cli
    from param_tpu_torch.ops.inference import (
        mlp_forward_int4, pack_int4_mlp, quantize_weights_int4,
    )
    from param_tpu_torch.ops.mlp import init_mlp

    def drive(label, cli_main, argv, table_rows, must, phase=10):
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
                if re.match(r"\s*(gemm|emb|mlp|mlp_infer|att:\w+|decode|"
                            r"decode-gqa|serve|serve-\w+|tf-fwd:\w+|"
                            r"att-grad:\w+|tf:\w+)\s+\(",
                            ln)
                or re.match(r"\s*\d+\s+\d+\s+\d+\s+(torch|K3)\s", ln)]
        nums = [float(x) for ln in rows
                for x in re.findall(r"\s(-?[\d.]+(?:e[+-]?\d+)?)%?(?=\s|$)",
                                    ln.split(")")[-1])]
        if rc != 0 or len(rows) != table_rows or not nums or \
                not all(math.isfinite(v) for v in nums):
            fail(f"phase {phase} {label}: rc {rc}, {len(rows)} result rows "
                 f"(want {table_rows}), output:\n{out}")
        missing = [k for k in must if counts.get(k, 0) <= 0]
        if missing:
            fail(f"phase {phase} {label}: {missing} not launched ({counts})")
        say(f"phase {phase} {label}: {' '.join(argv)} | {wall:.1f} s | launches "
            f"{counts} | {smi}\n{out.rstrip()}")
        return dict(argv=argv, launches=counts, wall_s=wall, output=out)

    cli_runs = {
        "gemm_A_bf16_K3": drive(
            "gemm A bf16 K3", compute_cli.main,
            ["gemm", "--dataset", "A", "--dtype", "bfloat16", "--pallas"],
            15, ["gemm_bf16", "gemm_wgmma"]),
        "gemm_C_compare": drive(
            "gemm C compare", compute_cli.main,
            ["gemm", "--dataset", "C", "--compare"], 8, ["gemm_f32"]),
        "gemm_wres_K4": drive(
            "gemm weight-resident K4", compute_cli.main,
            ["gemm", "--weight-resident", "8", "--shape", "128,4096,4096",
             "--dtype", "bfloat16"], 1, ["gemm_wres", "gemm_wgmma"]),
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
    n_inf = cli_runs["inference_int4_K5"]["launches"]
    if n_inf["int4_gemm"] % 18 or \
            n_inf.get("int4_gemm_wgmma", 0) != n_inf["int4_gemm"]:
        fail(f"phase 10: the int4 bench's K5 launches are not 18 per forward "
             f"on the wgmma path ({n_inf})")

    # one full-width int4 forward: exactly 18 K5 launches
    qp = pack_int4_mlp(quantize_weights_int4(init_mlp(
        torch.Generator(device=dev).manual_seed(0), [4096] * 19, device=dev)))
    xq = torch.rand((512, 4096), generator=gen, device=dev).bfloat16()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = mlp_forward_int4(qp, xq)
    torch.cuda.synchronize()
    if kernels.launch_counts["int4_gemm"] != 18 or \
            kernels.launch_counts["int4_gemm_wgmma"] != 18 or \
            out.shape != (512, 4096) or not torch.isfinite(out.float()).all():
        fail(f"phase 10: one int4 forward launched K5 "
             f"{kernels.launch_counts['int4_gemm']} times, "
             f"{kernels.launch_counts['int4_gemm_wgmma']} on wgmma (want 18 "
             f"and 18), output {tuple(out.shape)}")
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
    say(f"phase 10 int4 forward: 18 K5 launches per full-width forward, all "
        f"on the wgmma path; "
        f"small int4 MLP card vs CPU max abs err {worst:.3e} (tol 2e-2 x "
        f"max|out|, one bf16 rounding per layer) | {smi}")
    result["phases"]["cli"] = cli_runs
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 11
    from param_tpu_torch.kernels.flash_fwd import (
        PATHS as FLASH_PATHS, attention_keep_mask, flash_fwd_cuda,
        flash_fwd_plain, flash_fwd_tolerance, flash_schedule, tma_takes,
    )

    def flash_path(kernel, fn, views):
        """fn() and the path of ``kernel`` whose launch counter it moved;
        fails unless that is the path flash_schedule gives ``views`` and,
        for dense 16-bit views at D 64 / 128, unless it is wgmma."""
        before = {p: kernels.launch_counts[f"{kernel}_{p}"]
                  for p in FLASH_PATHS}
        out = fn()
        moved = [p for p in FLASH_PATHS
                 if kernels.launch_counts[f"{kernel}_{p}"] != before[p]]
        q = views[0]
        want = flash_schedule(q.dtype, q.shape[-1],
                              all(tma_takes(t) for t in views))
        if moved != [want] or (q.dtype != torch.float32
                               and q.shape[-1] in (64, 128)
                               and want != "wgmma"):
            fail(f"{kernel}: ran {moved}, the schedule says {want}")
        return out, want

    def kept_pairs(sq, sk, causal, window):
        """(row, column) pairs the mask keeps: the work this run needs."""
        keep = attention_keep_mask(sq, sk, causal, window, "cpu")
        return sq * sk if keep is None else int(keep.sum())

    k6 = {}

    def check_k6(name, got, want, tol):
        """Every element within its own bound (``flash_fwd_tolerance``) and,
        for bf16 / f16, the largest error within 2e-2 as well; returns the
        largest error and the largest ratio of error to bound."""
        err = check(f"K6 {name}", got, want, 2e-2)
        ratio = ((got.float() - want.float()).abs() / tol).max().item()
        if not ratio <= 1.0:
            fail(f"K6 {name}: an element's error is {ratio:.3f} x its bound")
        return err, ratio

    def planted_fault(q, k, v, want, tol):
        """K6 with each row's diagonal kv entry dropped (row r attends
        0..r-1, the fault of an off-by-one in the diagonal tile), held to
        the bounds of the right output on the rows r >= S/2, where one
        kv entry of ~S moves O least."""
        bad = flash_fwd_cuda(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1], True)
        late = slice(q.shape[2] // 2 - 1, None)
        diff = (bad[:, :, late].float()
                - want[:, :, 1:][:, :, late].float()).abs()
        over = int((diff > tol[:, :, 1:][:, :, late]).sum())
        rec = dict(elements=diff.numel(), over_bound=over,
                   over_flat=int((diff > 2e-2).sum()),
                   max_abs_err=diff.max().item())
        if over == 0:
            fail(f"K6 tolerance: a dropped diagonal kv entry is not flagged "
                 f"({rec})")
        return rec

    def k6_case(name, b, h, hkv, sq, sk, d, causal, window, dt, iters,
                fault=False):
        q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
        (got, lse), path = flash_path(
            "flash_fwd",
            lambda: flash_fwd_cuda(q, k, v, causal, None, window, True),
            (q, k, v))
        want, want_lse = flash_fwd_plain(q, k, v, causal, None, window, True)
        tol = flash_fwd_tolerance(q, k, v, want, causal, None, window)
        err, ratio = check_k6(name, got, want, tol)
        lse_err = check(f"K6 {name} lse", lse, want_lse, 1e-4)
        fault_rec = planted_fault(q, k, v, want, tol) if fault else None
        del got, want, lse, want_lse, tol
        keep = attention_keep_mask(sq, sk, causal, window, dev)
        if window is not None or (causal and sq != sk):
            # SDPA's is_causal aligns top-left: give it the mask itself
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=keep, enable_gqa=hkv != h)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=hkv != h)
        rec = timings(lambda: flash_fwd_cuda(q, k, v, causal, None, window),
                      lambda: flash_fwd_plain(q, k, v, causal, None, window),
                      lib, iters)
        flops = 4 * b * h * d * kept_pairs(sq, sk, causal, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound_ms(nbytes, flops, fp32=dt == torch.float32,
                              split_tf32=True)
        shape = (f"q ({b}, {h}, {sq}, {d}) k/v ({b}, {hkv}, {sk}, {d}) "
                 f"{str(dt)[6:]}{' causal' if causal else ''}"
                 f"{f' window {window}' if window else ''}")
        rec.update(shape=shape, max_abs_err=err, err_over_bound=ratio,
                   lse_err=lse_err, bound_ms=b_ms, bound_by=b_by, flops=flops,
                   bytes=nbytes, tflops=flops / rec["ms"] / 1e9,
                   planted_fault=fault_rec, path=path)
        k6[name] = rec
        bound_text = ("2e-5" if dt == torch.float32 else
                      "u (2|O| + |P||V|) per element, and 2e-2")
        say(f"phase 11 K6 {name}: {shape} | path {path} | max_abs_err "
            f"{err:.3e}, largest "
            f"error / bound {ratio:.3f} (bound {bound_text}), lse "
            f"{lse_err:.3e} (tol 1e-4) | "
            f"{timing_text(rec, 'F.scaled_dot_product_attention')} "
            f"({rec['tflops']:.1f} TF/s) bound {b_ms:.4f} ms ({b_by}) | {smi}")
        if fault_rec:
            say(f"phase 11 K6 {name} planted fault (diagonal kv entry "
                f"dropped), rows >= S/2: {fault_rec['over_bound']} of "
                f"{fault_rec['elements']} elements over their bound, "
                f"{fault_rec['over_flat']} over a flat 2e-2, max abs "
                f"err {fault_rec['max_abs_err']:.3e}")
        del q, k, v, keep

    bf16, f32 = torch.bfloat16, torch.float32
    k6_case("llama2_causal", 1, 32, 32, 2048, 2048, 128, True, None, bf16, 20,
            fault=True)
    k6_case("gpt2", 8, 12, 12, 1024, 1024, 64, False, None, bf16, 20)
    k6_case("gqa_causal", 1, 32, 8, 2048, 2048, 128, True, None, bf16, 20)
    k6_case("window_512", 1, 32, 32, 2048, 2048, 128, True, 512, bf16, 20)
    k6_case("rect_causal", 1, 32, 32, 128, 2048, 128, True, None, bf16, 20)
    # f32 (the tf32x3 path) at the attention CLIs' widths, and small
    k6_case("f32_llama2_causal", 1, 32, 32, 2048, 2048, 128, True, None, f32,
            10, fault=True)
    k6_case("f32_gpt2", 8, 12, 12, 1024, 1024, 64, False, None, f32, 10)
    k6_case("f32", 1, 4, 4, 512, 512, 64, True, None, f32, 20)
    k6_case("ragged_1000", 1, 4, 4, 1000, 1000, 128, True, None, bf16, 20)
    result["phases"]["k6"] = k6
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 12
    from param_tpu_torch.models import transformer as tfm

    def to_dev(params):
        return {key: (tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
                            for t in val) if isinstance(val, tuple)
                      else val.to(dev)) for key, val in params.items()}

    def block_cfg(dtype, kv_heads, seq, attention="flash"):
        return tfm.TransformerConfig(batch=2, seq=seq, emb=512, heads=8,
                                     ffn=1024, attention=attention,
                                     dtype=dtype, kv_heads=kv_heads)

    parity = {}
    for dtype, kv_heads in (("float32", None), ("float32", 2),
                            ("bfloat16", None)):
        cfg = block_cfg(dtype, kv_heads, 192)
        p_cpu = tfm.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
        x_cpu = (torch.randn((2, 192, 512),
                             generator=torch.Generator().manual_seed(3))
                 * 0.1).to(p_cpu["w1"].dtype)
        p_gpu, x_gpu = to_dev(p_cpu), x_cpu.to(dev)
        tol_rel = 1e-4 if dtype == "float32" else 2e-2
        kernels.reset_launch_counts()
        with torch.no_grad():
            outs = [("block_apply", tfm.block_apply(p_cpu, x_cpu, cfg),
                     tfm.block_apply(p_gpu, x_gpu, cfg))]
            pre = block_cfg(dtype, kv_heads, 160)
            o_c, c_c = tfm.prefill(p_cpu, x_cpu[:, :160], pre, 192)
            o_g, c_g = tfm.prefill(p_gpu, x_gpu[:, :160], pre, 192)
            outs.append(("prefill", o_c, o_g))
            step_cfg = block_cfg(dtype, kv_heads, 1)
            for t in range(160, 164):
                o_c, c_c = tfm.decode_step(p_cpu, c_c, x_cpu[:, t:t + 1], t,
                                           step_cfg, window=64)
                o_g, c_g = tfm.decode_step(p_gpu, c_g, x_gpu[:, t:t + 1], t,
                                           step_cfg, window=64)
                outs.append((f"decode_step {t}", o_c, o_g))
            if dtype == "float32":  # the int4 decode step: K5 on the card
                q4_c = tfm.cast_int4_params(
                    tfm.quantize_block_weights_int4(p_cpu))
                q4_g = to_dev(q4_c)
                outs.append(("int4 decode_step",
                             tfm.decode_step(q4_c, c_c, x_cpu[:, 164:165],
                                             164, step_cfg)[0],
                             tfm.decode_step(q4_g, c_g, x_gpu[:, 164:165],
                                             164, step_cfg)[0]))
        counts = {k: v for k, v in kernels.launch_counts.items() if v}
        if counts.get("flash_fwd", 0) != 2:
            fail(f"phase 12 {dtype} kv_heads {kv_heads}: K6 launches "
                 f"{counts} (want 2: block_apply and prefill)")
        worst = 0.0
        for label, want, got in outs:
            want, got = want.float(), got.float().cpu()
            err = (want - got).abs().max().item()
            tol = tol_rel * want.abs().max().item()
            worst = max(worst, err / want.abs().max().item())
            if not torch.isfinite(got).all() or not err <= tol:
                fail(f"phase 12 {dtype} kv_heads {kv_heads} {label}: card vs "
                     f"CPU max abs err {err:.3e} > {tol:.3e}")
        parity[f"{dtype}_kv{kv_heads}"] = dict(worst_rel_err=worst,
                                               launches=counts)
        say(f"phase 12 model parity {dtype} kv_heads {kv_heads}: block_apply "
            f"(flash), prefill, 4 windowed decode_steps"
            f"{', an int4 decode_step' if dtype == 'float32' else ''} on the "
            f"card vs the CPU: worst err {worst:.3e} x max|out| (tol "
            f"{tol_rel:.0e}) | launches {counts}")
    result["phases"]["transformer_parity"] = parity

    # ---------------------------------------------------------------- 13
    LLAMA2 = (4096, 32, 11008)  # emb, heads, ffn
    # the serve path's QKV and output projections at batch 1, 8 and 32
    # (phase 9 has its FFN projections)
    for mm in (1, 8, 32):
        k5_case(mm, 4096, 12288, 13)
        k5_case(mm, 4096, 4096, 13)
    serve_runs = {
        "attention_llama2": drive(
            "attention llama2", compute_cli.main,
            ["attention", "--dataset", "llama2", "--paths", "xla,flash,dpa"],
            9, ["flash_fwd"], 13),
        "transformer_llama2": drive(
            "transformer llama2 fwd", compute_cli.main,
            ["transformer", "--dataset", "llama2", "--fwd-only", "--paths",
             "flash,xla"], 2, ["flash_fwd"], 13),
        # f32 attention (K6's tf32x3 path) at both datasets' widths
        "attention_llama2_f32": drive(
            "attention llama2 f32", compute_cli.main,
            ["attention", "--dataset", "llama2", "--dtype", "float32",
             "--paths", "flash,dpa"], 6, ["flash_fwd_tf32x3"], 13),
        "attention_gpt2_f32": drive(
            "attention gpt2 f32", compute_cli.main,
            ["attention", "--dataset", "gpt2", "--dtype", "float32",
             "--paths", "flash,dpa"], 6, ["flash_fwd_tf32x3"], 13),
        "decode_llama3_gqa": drive(
            "decode llama3-gqa", compute_cli.main,
            ["decode", "--dataset", "llama3-gqa"], 3, [], 13),
        "serve_llama2_bf16": drive(
            "serve llama2 bf16", compute_cli.main,
            ["serve", "--dataset", "llama2"], 3, [], 13),
        "serve_llama2_int4": drive(
            "serve llama2 int4", compute_cli.main,
            ["serve", "--dataset", "llama2", "--dtype", "int4"], 3,
            ["int4_gemm"], 13),
    }
    # 3 shapes x 16 calls x (1 untimed + 5 timed windows) x 4 projections
    n_serve = serve_runs["serve_llama2_int4"]["launches"]["int4_gemm"]
    n_stream = serve_runs["serve_llama2_int4"]["launches"].get(
        "int4_gemm_stream", 0)
    if n_serve != 3 * 16 * 6 * 4 or n_stream != n_serve:
        fail(f"phase 13: serve int4 launched K5 {n_serve} times, {n_stream} "
             f"on the stream path, not 4 per decode step, all streamed "
             f"({3 * 16 * 6 * 4})")
    # one full-width int4 decode step: exactly 4 K5 launches
    e, h, ff = LLAMA2
    cfg = tfm.TransformerConfig(batch=1, seq=1, emb=e, heads=h, ffn=ff,
                                attention="xla")
    p4 = tfm.cast_int4_params(tfm.quantize_block_weights_int4(
        tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)))
    shape = (1, h, 2048, e // h)
    cache = {"k": torch.randn(shape, generator=gen, device=dev).bfloat16(),
             "v": torch.randn(shape, generator=gen, device=dev).bfloat16()}
    x1 = (torch.randn((1, 1, e), generator=gen, device=dev) * 0.1).bfloat16()
    kernels.reset_launch_counts()
    with torch.no_grad():
        out, _ = tfm.decode_step(p4, cache, x1, 2046, cfg)
    torch.cuda.synchronize()
    if kernels.launch_counts["int4_gemm"] != 4 or \
            kernels.launch_counts["int4_gemm_stream"] != 4 or \
            out.shape != (1, 1, e) or not torch.isfinite(out.float()).all():
        fail(f"phase 13: one int4 decode step launched K5 "
             f"{kernels.launch_counts['int4_gemm']} times, "
             f"{kernels.launch_counts['int4_gemm_stream']} on the stream path "
             f"(want 4 and 4)")
    say(f"phase 13 int4 decode step: 4 K5 launches, all on the stream path, "
        f"per full-width llama2 "
        f"decode step; the serve bench launched K5 {n_serve} times for "
        f"{3 * 16 * 6} steps | {smi}")
    del p4, cache, x1, out
    result["phases"]["serve_cli"] = serve_runs

    def breakdown(label, fn, n=20, grad=False, phase=13):
        """Host-clock ms per call (unprofiled, synchronised), and the
        card's kernel time per call from torch.profiler with its top
        kernels: how far the host holds the card back.  ``grad`` runs
        ``fn`` with autograd on (a train step)."""
        with contextlib.nullcontext() if grad else torch.no_grad():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                    ev.self_device_time_total / 1e3 / n
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        say(f"phase {phase} breakdown {label}: {wall:.4f} ms per call (host "
            f"clock), kernels {busy:.4f} ms ({100 * busy / wall:.1f}% of it) "
            f"| top kernels per call: "
            + "; ".join(f"{name[:70]} {ms:.4f} ms" for name, ms in top)
            + f" | {smi}")
        return dict(wall_ms=wall, device_ms=busy, top=top, by_name=by_name)

    rows = {}
    for path in ("flash", "xla"):
        cfg = tfm.TransformerConfig(batch=1, seq=2048, emb=e, heads=h,
                                    ffn=ff, attention=path)
        p_bf = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, dev)
        x = (torch.randn((1, 2048, e), generator=gen, device=dev)
             * 0.1).bfloat16()
        rows[f"tf_fwd_{path}"] = breakdown(
            f"transformer fwd {path} (1, 2048, 4096, 32, 11008) bf16",
            lambda: tfm.block_apply(p_bf, x, cfg), 10)
    cfg = tfm.TransformerConfig(batch=1, seq=1, emb=e, heads=h, ffn=ff,
                                attention="xla")
    p_int4 = tfm.cast_int4_params(tfm.quantize_block_weights_int4(p_bf))
    for b in (1, 32):
        shape = (b, h, 2048, e // h)
        cache = {"k": torch.randn(shape, generator=gen, device=dev).bfloat16(),
                 "v": torch.randn(shape, generator=gen, device=dev).bfloat16()}
        x1 = (torch.randn((b, 1, e), generator=gen, device=dev)
              * 0.1).bfloat16()
        for name, params in (("bf16", p_bf), ("int4", p_int4)):
            rows[f"serve_{name}_b{b}"] = breakdown(
                f"serve decode_step {name} batch {b} (cache 2048, llama2)",
                lambda: tfm.decode_step(params, cache, x1, 2046, cfg))
        # the int4 step with K5 on the parent's design, in this run
        with k5mod.forced_path("mma_sync"):
            rows[f"serve_int4_b{b}_parent_k5"] = breakdown(
                f"serve decode_step int4 batch {b}, K5 on the parent's design "
                f"(mma_sync + reduce)",
                lambda: tfm.decode_step(p_int4, cache, x1, 2046, cfg))
        del cache, x1
    del p_bf, p_int4, x
    result["phases"]["breakdown"] = rows

    # ---------------------------------------------------------------- 14
    from param_tpu_torch.kernels.flash_bwd import (
        flash_bwd_cuda, flash_bwd_plain, flash_bwd_tolerance,
    )

    k7 = {}
    aten = torch.ops.aten

    def check_k7(name, got, want, tols):
        """Every element of dq, dk and dv within its own bound; returns the
        largest error and the largest ratio of error to bound."""
        torch.cuda.synchronize()
        err = ratio = 0.0
        for label, g, w, t in zip(("dq", "dk", "dv"), got, want, tols):
            if g.shape != w.shape or not torch.isfinite(g.float()).all():
                fail(f"K7 {name} {label}: shape {tuple(g.shape)} (want "
                     f"{tuple(w.shape)}) or non-finite output")
            diff = (g.float() - w.float()).abs()
            err = max(err, diff.max().item())
            ratio = max(ratio, (diff / t).max().item())
        if not ratio <= 1.0:
            fail(f"K7 {name}: an element's error is {ratio:.3f} x its bound")
        return err, ratio

    def k7_fault(q, k, v, o, lse, do, want, tols):
        """K7 with each row's diagonal kv entry dropped (row r attends
        0..r-1, the true lse kept): elements of dq, dk and dv over the
        bounds of the right gradients."""
        bad = flash_bwd_cuda(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1],
                             o[:, :, 1:], lse[:, :, 1:].contiguous(),
                             do[:, :, 1:], True)
        rec = {}
        for i, (label, cut) in enumerate((("dq", slice(1, None)),
                                          ("dk", slice(None, -1)),
                                          ("dv", slice(None, -1)))):
            diff = (bad[i].float() - want[i][:, :, cut].float()).abs()
            rec[label] = int((diff > tols[i][:, :, cut]).sum())
        rec["elements"] = bad[0].numel()
        if min(rec["dq"], rec["dk"], rec["dv"]) == 0:
            fail(f"K7 tolerance: a dropped diagonal kv entry is not flagged "
                 f"in every gradient ({rec})")
        return rec

    def sdpa_backward_kernels(q, k, v, do, causal):
        """SDPA's backward through autograd (enable_gqa when H_kv < H), the
        library call where no graph-timed aten backward takes the inputs:
        kernel ms per call from torch.profiler, and its largest kernels
        (which name the backend PyTorch picked)."""
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=k.shape[1] != q.shape[1])
        return profiled_kernels(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True))

    def k7_case(name, b, h, hkv, sq, sk, d, causal, dt, iters, fault=False,
                no_library=None, fused=False, repeat=False,
                sdpa_autograd=False):
        """``fused``: q, k, v are the strided head views of one (b, s,
        (h + 2 hkv) d) projection and dO the transposed-head view of a
        (b, s, h d) gradient, as the train step hands them to K7.
        ``repeat``: a second run must give bitwise-equal gradients.
        ``sdpa_autograd``: the library column is SDPA's backward through
        autograd (``sdpa_backward_kernels``)."""
        if fused:
            y = torch.randn((b, sq, (h + 2 * hkv) * d), generator=gen,
                            device=dev).to(dt)
            cfg = tfm.TransformerConfig(batch=b, seq=sq, emb=h * d, heads=h,
                                        ffn=1, kv_heads=hkv)
            q, k, v = tfm._split_heads(y, cfg, b, sq)
            do = torch.randn((b, sq, h * d), generator=gen,
                             device=dev).to(dt).reshape(b, sq, h, d)
            do = do.transpose(1, 2)
            if any(t.is_contiguous() for t in (q, k, v, do)):
                fail(f"K7 {name}: an input is not a strided view")
        else:
            q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
            k = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
            v = torch.randn((b, hkv, sk, d), generator=gen, device=dev).to(dt)
            do = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dt)
        o, lse = flash_fwd_cuda(q, k, v, causal, None, None, True)  # K6
        ins = (q, k, v, o, lse, do)
        got, path = flash_path("flash_bwd",
                               lambda: flash_bwd_cuda(*ins, causal),
                               (q, k, v, o, do))
        want = flash_bwd_plain(*ins, causal)
        tols = flash_bwd_tolerance(*ins, want, causal)
        err, ratio = check_k7(name, got, want, tols)
        fault_rec = k7_fault(*ins, want, tols) if fault else None
        if repeat:
            again = flash_bwd_cuda(*ins, causal)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"K7 {name}: two runs on the same inputs differ")
            del again
        del got, want, tols
        torch.cuda.empty_cache()
        autograd_lib = None
        if sdpa_autograd:
            autograd_lib = sdpa_backward_kernels(q, k, v, do, causal)
            lib, no_library = None, "no graph-timed call"
        elif no_library is None:
            # SDPA's flash backward on SDPA's own forward residuals
            res = aten._scaled_dot_product_flash_attention(q, k, v, 0.0,
                                                           causal, False)
            out, lse_lib, cq, ck, mq, mk, seed, off, _ = res
            lib = lambda: aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
                do, q, k, v, out, lse_lib, cq, ck, mq, mk, 0.0, causal, seed,
                off)
        else:
            lib = None
        rec = timings(lambda: flash_bwd_cuda(*ins, causal),
                      lambda: flash_bwd_plain(*ins, causal), lib, iters)
        if autograd_lib is not None:
            rec["library_ms"] = autograd_lib["ms"]
            rec["library_kernels"] = autograd_lib["kernels"]
            # the kernel timed the library's way too, for a like-for-like
            # ratio
            rec["profiled_ms"] = profiled_kernels(
                lambda: flash_bwd_cuda(*ins, causal))["ms"]
        flops = 10 * b * h * d * kept_pairs(sq, sk, causal, None)
        nbytes = ((2 * (q.numel() + k.numel() + v.numel()) + o.numel()
                   + do.numel()) * q.element_size() + lse.numel() * 4)
        b_ms, b_by = bound_ms(nbytes, flops, fp32=dt == torch.float32,
                              split_tf32=True)
        shape = (f"q ({b}, {h}, {sq}, {d}) k/v ({b}, {hkv}, {sk}, {d}) "
                 f"{str(dt)[6:]}{' causal' if causal else ''}"
                 f"{' strided (fused qkv, transposed dO)' if fused else ''}")
        rec.update(shape=shape, max_abs_err=err, err_over_bound=ratio,
                   bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                   tflops=flops / rec["ms"] / 1e9, planted_fault=fault_rec,
                   no_library=no_library, path=path)
        k7[name] = rec
        bound_text = ("2^-14 (|X| + m) + 1e-6" if dt == torch.float32 else
                      "u (2|X| + m) per element")
        lib_text = ("aten._scaled_dot_product_flash_attention_backward"
                    if lib else f"none ({no_library})")
        text = timing_text(rec, lib_text)
        if autograd_lib is not None:
            text += (f"; library: SDPA's backward through autograd "
                     f"(enable_gqa={hkv != h}) {autograd_lib['ms']:.4f} ms of "
                     f"kernel time a call (torch.profiler), largest kernels "
                     f"{autograd_lib['kernels']}; K7 timed the same way "
                     f"{rec['profiled_ms']:.4f} ms")
        say(f"phase 14 K7 {name}: {shape} | path {path} | max_abs_err "
            f"{err:.3e} over dq, dk, dv, largest error / bound {ratio:.3f} "
            f"(bound {bound_text}) | {text} ({rec['tflops']:.1f} TF/s) bound "
            f"{b_ms:.4f} ms ({b_by}) | {smi}")
        if fault_rec:
            say(f"phase 14 K7 {name} planted fault (diagonal kv entry "
                f"dropped): elements over their bound dq {fault_rec['dq']}, "
                f"dk {fault_rec['dk']}, dv {fault_rec['dv']} of "
                f"{fault_rec['elements']} each")
        del q, k, v, do, o, lse, ins
        torch.cuda.empty_cache()

    k7_case("llama2_causal", 1, 32, 32, 2048, 2048, 128, True, bf16, 20,
            fault=True, repeat=True)
    # the train step's layout, and the other two ATTN_LLAMA2 shapes of
    # attention --dataset llama2 --grad
    k7_case("llama2_fused", 1, 32, 32, 2048, 2048, 128, True, bf16, 20,
            fused=True)
    k7_case("llama2_s4096", 1, 32, 32, 4096, 4096, 128, True, bf16, 10)
    k7_case("llama2_b4", 4, 32, 32, 2048, 2048, 128, True, bf16, 10)
    k7_case("gpt2", 8, 12, 12, 1024, 1024, 64, False, bf16, 20)
    k7_case("gqa_causal", 1, 32, 8, 2048, 2048, 128, True, bf16, 20,
            sdpa_autograd=True)
    k7_case("rect_causal", 1, 32, 32, 128, 2048, 128, True, bf16, 20,
            no_library="SDPA's causal mask aligns top-left, the reference's "
                       "bottom-right for S_q < S_k")
    k7_case("f32_llama2_causal", 1, 32, 32, 2048, 2048, 128, True, f32, 10,
            fault=True, repeat=True, sdpa_autograd=True)
    k7_case("f32_gpt2", 8, 12, 12, 1024, 1024, 64, False, f32, 10,
            sdpa_autograd=True)
    k7_case("f32", 1, 4, 4, 512, 512, 64, True, f32, 20, sdpa_autograd=True)
    k7_case("ragged_1000", 1, 4, 4, 1000, 1000, 128, True, bf16, 20)
    k7_case("d32", 4, 16, 16, 1024, 1024, 32, True, bf16, 20)
    result["phases"]["k7"] = k7

    # ---------------------------------------------------------------- 15
    def bf16_ulp(x):
        return torch.exp2(torch.floor(torch.log2(
            x.abs().clamp_min(2.0 ** -126))) - 7)

    train_parity = {}
    for dtype, kv_heads in (("float32", None), ("float32", 2),
                            ("bfloat16", None)):
        cfg = block_cfg(dtype, kv_heads, 192)
        lr = 0.1 if dtype == "float32" else 1.0
        p_cpu = tfm.init_params(torch.Generator().manual_seed(4), cfg, "cpu")
        x_cpu = (torch.randn((2, 192, 512),
                             generator=torch.Generator().manual_seed(5))
                 * 0.1).to(p_cpu["w1"].dtype)
        p_gpu, x_gpu = to_dev(p_cpu), x_cpu.to(dev)
        step = tfm.make_train_step(cfg, lr=lr)
        p0 = tfm.leaves(p_cpu)
        worst_loss = worst_param = 0.0
        for t in range(2):
            p_cpu, l_cpu = step(p_cpu, x_cpu)
            kernels.reset_launch_counts()
            p_gpu, l_gpu = step(p_gpu, x_gpu)
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts.items() if v}
            if counts.get("flash_fwd") != 1 or counts.get("flash_bwd") != 1:
                fail(f"phase 15 {dtype} kv_heads {kv_heads} step {t}: "
                     f"launches {counts} (want K6 once and K7 once)")
            rel = abs(l_gpu.item() - l_cpu.item()) / l_cpu.item()
            worst_loss = max(worst_loss, rel)
            if not rel <= (1e-5 if dtype == "float32" else 2e-3):
                fail(f"phase 15 {dtype} kv_heads {kv_heads} step {t}: loss "
                     f"card {l_gpu.item()} CPU {l_cpu.item()}")
        for got, want, before in zip(tfm.leaves(p_gpu), tfm.leaves(p_cpu),
                                     p0):
            got, want = got.float().cpu(), want.float()
            diff = (got - want).abs()
            if dtype == "float32":
                tol = 1e-5 * want.abs().max().item() + 1e-7
            else:
                # two bf16 ulps (each step's rounding of the update may
                # flip), plus 5e-2 of the largest update: the card's K6 / K7
                # round P and dS to bf16 where the CPU's plain versions
                # do not, and its GEMMs sum in another order
                tol = 2 * bf16_ulp(torch.maximum(got.abs(), want.abs())) + \
                    5e-2 * (want - before.float()).abs().max().item()
            ratio = (diff / tol).max().item()
            worst_param = max(worst_param, ratio)
            if not ratio <= 1.0 or not torch.isfinite(got).all():
                fail(f"phase 15 {dtype} kv_heads {kv_heads}: a parameter "
                     f"after two steps is {ratio:.3f} x its bound from the "
                     f"CPU's")
        train_parity[f"{dtype}_kv{kv_heads}"] = dict(
            worst_loss_rel=worst_loss, worst_param_over_bound=worst_param)
        say(f"phase 15 train-step parity {dtype} kv_heads {kv_heads} (batch "
            f"2, seq 192, emb 512, 8 heads, ffn 1024, lr {lr}): two steps on "
            f"the card (K6 and K7 once each per step) vs the CPU: loss rel "
            f"err {worst_loss:.3e}, largest param error / bound "
            f"{worst_param:.3f} | {smi}")
    result["phases"]["train_parity"] = train_parity
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 16
    train_runs = {
        "attention_llama2_grad": drive(
            "attention llama2 grad", compute_cli.main,
            ["attention", "--dataset", "llama2", "--grad", "--paths",
             "xla,flash,dpa"], 9, ["flash_fwd", "flash_bwd"], 16),
        "transformer_llama2_train": drive(
            "transformer llama2 train", compute_cli.main,
            ["transformer", "--dataset", "llama2", "--paths", "flash,xla"], 2,
            ["flash_fwd", "flash_bwd"], 16),
        # f32 (K6 and K7 on their tf32x3 path)
        "attention_llama2_f32_grad": drive(
            "attention llama2 f32 grad", compute_cli.main,
            ["attention", "--dataset", "llama2", "--dtype", "float32",
             "--grad", "--paths", "flash,dpa"], 6,
            ["flash_fwd_tf32x3", "flash_bwd_tf32x3"], 16),
    }
    # 8 steps x (1 untimed + 5 timed windows) on the flash path
    tl = train_runs["transformer_llama2_train"]["launches"]
    if tl.get("flash_fwd") != 48 or tl.get("flash_bwd") != 48:
        fail(f"phase 16: transformer train launched {tl}, not K6 and K7 "
             f"once per flash step (48)")
    al = train_runs["attention_llama2_grad"]["launches"]
    if al.get("flash_bwd") != al.get("flash_fwd"):
        fail(f"phase 16: attention --grad launched {al}, not one K7 per K6")

    def shares(row):
        """Kernel ms per step of K6, K7, the cuBLAS GEMMs (nvjet, xmma,
        cutlass kernels) and everything else (elementwise, reductions)."""
        by = row["by_name"]
        pick = lambda f: sum(ms for nm, ms in by.items() if f(nm))  # noqa: E731
        rec = dict(
            k6=pick(lambda nm: "flash_fwd" in nm),
            k7=pick(lambda nm: "flash_bwd" in nm),
            cublas=pick(lambda nm: any(t in nm.lower() for t in (
                "gemm", "cutlass", "xmma", "nvjet", "cublas"))))
        rec["other"] = row["device_ms"] - sum(rec.values())
        return rec

    for path in ("flash", "xla"):
        cfg = tfm.TransformerConfig(batch=1, seq=2048, emb=e, heads=h,
                                    ffn=ff, attention=path)
        state = {"p": tfm.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)}
        x = (torch.randn((1, 2048, e), generator=gen, device=dev)
             * 0.1).bfloat16()
        step = tfm.make_train_step(cfg)

        def train(state=state, step=step, x=x):
            state["p"], loss = step(state["p"], x)
            return loss

        row = breakdown(f"train step {path} (1, 2048, 4096, 32, 11008) bf16",
                        train, 10, grad=True, phase=16)
        row.update(shares(row))
        rows[f"tf_train_{path}"] = row
        say(f"phase 16 train step {path}: kernel ms per step K6 "
            f"{row['k6']:.4f}, K7 {row['k7']:.4f}, cuBLAS GEMMs "
            f"{row['cublas']:.4f}, other {row['other']:.4f} of "
            f"{row['device_ms']:.4f} | {smi}")
        del state, x
        torch.cuda.empty_cache()
    result["phases"]["train_cli"] = train_runs

    # ---------------------------------------------------------------- 17
    from param_tpu_torch.kernels import ring as k8
    from param_tpu_torch.ops import ring_collectives as rings

    ring_kernels = {  # kernel: (wrapper, plain version, launch count)
        "all_gather": (k8.ring_all_gather_cuda, k8.ring_all_gather_plain,
                       "ring_all_gather"),
        "reduce_scatter": (k8.ring_reduce_scatter_cuda,
                           k8.ring_reduce_scatter_plain,
                           "ring_reduce_scatter"),
        "bidir": (k8.ring_all_gather_bidir_cuda,
                  k8.ring_all_gather_bidir_plain, "ring_bidir_all_gather"),
        "loopback": (k8.ring_loopback_cuda, k8.ring_loopback_plain,
                     "ring_loopback"),
    }
    ops_api = {"all_gather": rings.ring_all_gather,
               "all_reduce": rings.ring_all_reduce,
               "bidir": rings.ring_all_gather_bidir,
               "loopback": rings.loopback_remote_copy}

    def ring_shards(n, nbytes, dt):
        elems = nbytes // torch.empty((), dtype=dt).element_size()
        return [torch.randn((elems,), generator=gen, device=dev).to(dt)
                for _ in range(n)]

    def same_bytes(name, got, want):
        """Every byte of every rank's result equal; returns 0.0, the
        largest error."""
        torch.cuda.synchronize()
        if len(got) != len(want):
            fail(f"{name}: {len(got)} results for {len(want)} ranks")
        for r, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or not torch.equal(
                    g.view(torch.uint8), w.to(g.device).view(torch.uint8)):
                err = (g.float() - w.to(g.device).float()).abs().max().item() \
                    if g.shape == w.shape else float("nan")
                fail(f"{name}: rank {r} differs from the plain version "
                     f"(shape {tuple(g.shape)} vs {tuple(w.shape)}, max abs "
                     f"err {err:.3e})")
        return 0.0

    KIB, MIB = 1 << 10, 1 << 20

    # the op API, the path a user of the rings calls: every kernel launches,
    # K8a / K8b on each of their routes (at 8 MiB a rank K8b's cluster one)
    kernels.reset_launch_counts()
    for n, nbytes in ((1, MIB), (2, MIB), (4, MIB), (8, MIB), (8, 8 * MIB)):
        xs = ring_shards(n, nbytes, torch.float32)
        for name, fn in ops_api.items():
            if name == "all_reduce":
                want = rings.ring_all_reduce([x.cpu() for x in xs])
            else:
                want = ring_kernels[name][1](xs)
            same_bytes(f"phase 17 {name} n={n} {nbytes} B (op API)", fn(xs),
                       want)
        del xs
    ring_launches = {k: v for k, v in kernels.launch_counts.items()
                     if k.startswith("ring_")}
    if min(ring_launches.values()) <= 0:
        fail(f"phase 17: a ring kernel or route was not launched by the op "
             f"API ({ring_launches})")
    say(f"phase 17 op API (ring_all_gather, ring_all_reduce, "
        f"ring_all_gather_bidir, loopback_remote_copy at n 1, 2, 4, 8, 1 MiB "
        f"f32 per rank, and at n 8, 8 MiB): every result equal to the plain "
        f"rings | launches {ring_launches}")

    k8_rows = {}

    def ring_library(coll, xs):
        """One PyTorch call computing the same function on a stacked copy
        of the shards made here, outside any timed window: every rank's
        gather (shift 0) as one expand of the stack, the reduce-scatter's
        chunk sums as one sum over the ranks (rank r's result is row
        (r + 1) % n; the sums may differ from the ring's in the last bit,
        so this row compares time only); the loopback's copies as one
        ``X.clone()``.  Over one rank the gather is a copy, and
        ``expand().contiguous()`` of the stack a view, so the call there
        is ``X.clone()``."""
        n = len(xs)
        x = torch.stack(xs)
        if coll == "loopback" or (coll in ("all_gather", "bidir") and
                                  n == 1):
            return lambda: x.clone()
        if coll in ("all_gather", "bidir"):
            return lambda: x.expand(n, n, x.shape[1]).contiguous()
        return lambda: x.view(n, n, -1).sum(0)

    def k8_case(coll, n, nbytes, dt):
        cuda_fn, plain_fn, _ = ring_kernels[coll]
        xs = ring_shards(n, nbytes, dt)
        err = same_bytes(f"K8 {coll} n={n} {nbytes} B", cuda_fn(xs),
                         plain_fn(xs))
        plan = k8.launch_plan(coll, xs, nbytes // n
                              if coll == "reduce_scatter" else nbytes)
        # a window of about 1 GiB of input or more: 3 calls of a 64 MiB
        # copy are 0.15 ms, too short to read
        iters = 50 if nbytes <= MIB else max(3, (1 << 30) // (n * nbytes))
        rec = timings(lambda: cuda_fn(xs, check=False),
                      lambda: plain_fn(xs), ring_library(coll, xs), iters)
        k8.check_errors(xs)  # no wait ran out while timing
        if coll in ("all_gather", "bidir"):
            nbytes_io = n * nbytes + n * n * nbytes
        elif coll == "reduce_scatter":
            nbytes_io = n * nbytes + nbytes
        else:
            nbytes_io = 2 * n * nbytes
        adds = (n - 1) * nbytes // xs[0].element_size() \
            if coll == "reduce_scatter" else 0  # (n - 1) adds per element
        b_ms, b_by = bound_ms(nbytes_io, adds)
        size = f"{nbytes // MIB} MiB" if nbytes >= MIB else \
            f"{nbytes // KIB} KiB"
        rec.update(shape=f"n={n} ranks (one card), {size} {str(dt)[6:]} per "
                         f"rank", max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes_io,
                   gbps=nbytes_io / rec["ms"] / 1e6, plan=plan.text())
        k8_rows[f"{coll} n={n} {size} {str(dt)[6:]}"] = rec
        lib = {"all_gather": "X.expand(n, n, L).contiguous()",
               "bidir": "X.expand(n, n, L).contiguous()",
               "reduce_scatter": "X.view(n, n, c).sum(0)",
               "loopback": "X.clone()"}[coll]
        if n == 1 and coll in ("all_gather", "bidir"):
            lib = "X.clone()"
        copy = ""
        if coll == "loopback" and n == 1 and nbytes == 64 * MIB:
            # the same copy without the handshake: the kernel K8a-c take
            # over one rank, timed in this call
            rec["t_copy_kernel"] = timed(
                lambda: k8.ring_all_gather_cuda(xs, check=False), iters)
            k8.check_errors(xs)
            copy = (f" | ring_copy_kernel (K8a over one rank) "
                    f"{fmt(rec['t_copy_kernel'])}")
        say(f"phase 17 K8 {coll}: {rec['shape']}: every byte equal | plan "
            f"{plan.text()} | {timing_text(rec, lib)}{copy} "
            f"({rec['gbps']:.0f} GB/s of HBM: inputs read + outputs "
            f"written) bound {b_ms:.4f} ms ({b_by}) | {smi}")
        if coll == "reduce_scatter" and 2 <= n <= 8:
            # K8b's other route, held and timed too, with its own plain and
            # library times on the same inputs
            other = "memory" if plan.route == "cluster" else "cluster"
            with k8.forced_route(other):
                same_bytes(f"K8 {coll} n={n} {nbytes} B ({other} route)",
                           cuda_fn(xs), plain_fn(xs))
                orec = timings(lambda: cuda_fn(xs, check=False),
                               lambda: plain_fn(xs), ring_library(coll, xs),
                               iters)
                k8.check_errors(xs)
                oplan = k8.launch_plan(coll, xs, nbytes // n)
            orec.update(shape=rec["shape"], max_abs_err=err, bound_ms=b_ms,
                        bound_by=b_by, plan=oplan.text(),
                        gbps=nbytes_io / orec["ms"] / 1e6)
            rec[f"{other}_route"] = orec
            say(f"phase 17 K8 {coll}: {rec['shape']}, {other} route: every "
                f"byte equal | plan {oplan.text()} | "
                f"{timing_text(orec, lib)} | {smi}")
        del xs
        torch.cuda.empty_cache()
        return rec

    for coll in ring_kernels:
        for n in (1, 2, 4, 8):
            for nbytes, dt in ((4 * KIB, torch.float32),
                               (MIB, torch.float32),
                               (64 * MIB, torch.float32),
                               (MIB, torch.bfloat16)):
                k8_case(coll, n, nbytes, dt)
    # K8b's two routes about where ring_plan switches between them
    for n in (2, 4, 8):
        for nbytes in (2 * MIB, 4 * MIB, 16 * MIB):
            k8_case("reduce_scatter", n, nbytes, torch.float32)

    # a planted fault: rank 0 sends its first hop to right + 1
    fault_rec = {}
    for coll, route in (("all_gather", None), ("reduce_scatter", "memory"),
                        ("reduce_scatter", "cluster"), ("bidir", None)):
        cuda_fn, plain_fn, _ = ring_kernels[coll]
        name = coll if route is None else f"{coll} ({route} route)"
        xs = ring_shards(4, MIB, torch.float32)
        with (k8.forced_route(route) if route else contextlib.nullcontext()):
            t0 = time.perf_counter()
            try:
                cuda_fn(xs, fault=1, timeout_s=0.05)
            except RuntimeError as e:
                fault_rec[name] = dict(raised=str(e),
                                       seconds=time.perf_counter() - t0)
            else:
                fail(f"phase 17 K8 {name}: the planted fault was not "
                     f"flagged")
            same_bytes(f"K8 {name} after the fault", cuda_fn(xs),
                       plain_fn(xs))
        say(f"phase 17 K8 {name} planted fault (rank 0's first hop to "
            f"right + 1, n=4, 1 MiB): raised after "
            f"{fault_rec[name]['seconds']:.3f} s: {fault_rec[name]['raised']}"
            f" | the next call is right again")
    cards = torch.cuda.device_count()
    if cards >= 2:
        k8_rows.update(ring_across_cards(min(cards, 8), smi))
    else:
        say("phase 17: one card: the rings ran all ranks on it; the wire "
            "between cards (peer writes over NVLink) is unchecked")
    result["phases"]["k8"] = dict(rows=k8_rows, fault=fault_rec,
                                  launches=ring_launches, cards=cards)

    # ---------------------------------------------------------------- 18
    from param_tpu_torch.cli import comms as comms_cli

    def comms_run(argv, n_tables):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = comms_cli.main(argv + ["--log", "WARNING"])
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        rows = [ln for ln in out.splitlines()
                if re.match(r"\s+\d+[KMG]?\s+\d+\s", ln)]
        nums = [float(v) for ln in rows for v in ln.split()[1:]
                if re.fullmatch(r"-?[\d.]+", v)]
        if rc != 0 or out.count("COMMS-RES:") != n_tables or not rows or \
                any(not ln.endswith("  OK") for ln in rows) or \
                not all(math.isfinite(v) for v in nums):
            fail(f"phase 18 cli.comms {' '.join(argv)}: rc {rc}, dcheck not "
                 f"OK on every row or a table missing:\n{out}")
        say(f"phase 18 cli.comms {' '.join(argv)} | {wall:.1f} s | {smi}\n"
            f"{out.rstrip()}")
        return dict(argv=argv, wall_s=wall, output=out, rows=len(rows))

    comms_runs = {
        "dispatch": comms_run(
            ["--collective", "all_reduce,all_gather,reduce_scatter,"
             "all_to_all,broadcast,pt2pt", "--b", "8", "--e", "64M",
             "--c", "1"], 6),
        "graph": comms_run(
            ["--collective", "all_reduce,all_gather", "--b", "1K", "--e",
             "64M", "--f", "8", "--c", "1", "--mode", "graph"], 2),
    }
    if cards >= 2:
        torch.cuda.empty_cache()  # card 0 hosts the world's rank 0 too
        comms_runs["torchrun"] = comms_world(cards, smi)
    result["phases"]["comms_cli"] = comms_runs

    # ---------------------------------------------------------------- 19
    import numpy as np

    from param_tpu_torch import bench as port_bench
    from param_tpu_torch.experiments import coalesce as coal
    from param_tpu_torch.kernels import coalesce as kc
    from param_tpu_torch.models.dlrm_data import gen_indices

    torch.cuda.empty_cache()
    CE, CD = coal.E, coal.D
    ctab = torch.rand((CE, CD), generator=gen, device=dev)
    k9, k9_fault = {}, {}
    for k in coal.KS:
        n = coal.K_ROWS // k
        starts = torch.randint(0, CE - k, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
        shifted = [((starts + s) % (CE - k)).int() for s in range(8)]
        want = kc.desc_fetch_plain(ctab, starts, k)
        tol = 1e-4 * want.abs().max().item()
        err = check(f"K9 k={k}", kc.desc_fetch_cuda(ctab, starts, k), want,
                    tol)
        if k == 8:  # a planted fault: one start shifted by one row
            bad = starts.clone()
            bad[0] = (bad[0] + 1) % (CE - k)
            bad_err = (kc.desc_fetch_cuda(ctab, bad, k) - want).abs().max() \
                .item()
            if not bad_err > tol:
                fail(f"K9: a start shifted by one row is not flagged (err "
                     f"{bad_err:.3e}, tol {tol:.3e})")
            k9_fault = dict(max_abs_err=bad_err, tol=tol)
            say(f"phase 19 K9 planted fault (k 8, start 0 moved one row): "
                f"max abs err {bad_err:.3e} > tol {tol:.3e}, flagged")
        n_tiles = coal.K_ROWS // coal.ROWS_PER_TILE
        nbytes = coal.K_ROWS * CD * 4 + n * 4 + n_tiles * CD * 4
        b_ms, b_by = bound_ms(nbytes, coal.K_ROWS * CD)
        nk, npl = itertools.cycle(shifted), itertools.cycle(shifted)
        # the library call: F.embedding_bag over each tile's row ids
        nl = itertools.cycle([(st.long()[:, None] + torch.arange(
            k, device=dev)).reshape(n_tiles, -1) for st in shifted])
        rec = timings(lambda: kc.desc_fetch_cuda(ctab, next(nk), k),
                      lambda: kc.desc_fetch_plain(ctab, next(npl), k),
                      lambda: F.embedding_bag(next(nl), ctab, mode="sum"),
                      20)
        rec.update(shape=f"table ({CE}, {CD}) f32, {n} starts x {k} rows "
                         f"({coal.ROWS_PER_TILE} rows a tile)",
                   max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, gbps=nbytes / rec["ms"] / 1e6,
                   ns_per_copy=rec["ms"] * 1e6 / n)
        k9[k] = rec
        say(f"phase 19 K9 k={k}: {rec['shape']} max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) | {timing_text(rec, 'F.embedding_bag')} "
            f"({rec['gbps']:.0f} GB/s, "
            f"{rec['ns_per_copy']:.3f} ns per copy) bound {b_ms:.4f} ms "
            f"({b_by}) | {smi}")
        del starts, shifted, want

    k10 = {}
    crng = np.random.default_rng(0)
    for dist in ("uniform", "zipf"):
        if dist == "uniform":
            idx = torch.randint(0, CE, (coal.B, coal.NNZ), generator=gen,
                                device=dev, dtype=torch.int32)
        else:
            idx = torch.from_numpy(gen_indices(
                crng, coal.B, 1, coal.NNZ, CE, "zipf")[:, 0, :]).to(dev)
        ids = [((idx.long() + s) % CE).int() for s in range(8)]
        longs = [i.long() for i in ids]
        plans = [kc.coalesce_plan(i, CE, coal.R_BLK, coal.TILE_BAGS)
                 for i in ids]
        want = emb_gather_plain(ctab, ids[0])
        tol = 1e-5 * want.abs().max().item()
        err = check(f"K10 {dist}", kc.coalesced_bag_cuda(ctab, plans[0]),
                    want, tol)
        k1_err = check(f"K1 {dist} (stage B's ids)",
                       emb_gather_cuda(ctab, ids[0]), want, tol)
        uniq = torch.unique(ids[0]).numel()  # shifts are bijections
        blocks = int(plans[0].n_blocks.sum().item())
        nbytes = uniq * CD * 4 + idx.numel() * 4 + coal.B * CD * 4
        b_ms, b_by = bound_ms(nbytes, idx.numel() * CD)
        n1, n3 = itertools.cycle(plans), itertools.cycle(longs)
        n2, n4, n5 = (itertools.cycle(ids) for _ in range(3))
        rec = timings(lambda: kc.coalesced_bag_cuda(ctab, next(n1)),
                      lambda: emb_gather_plain(ctab, next(n2)),
                      lambda: F.embedding_bag(next(n3), ctab, mode="sum"), 20)
        rec["t_k1"] = timed(lambda: emb_gather_cuda(ctab, next(n4)), 20)
        rec["t_with_prepass"] = timed(
            lambda: kc.coalesced_bag(ctab, next(n5), coal.R_BLK,
                                     coal.TILE_BAGS), 20)
        rec.update(shape=f"table ({CE}, {CD}) f32, {coal.B} bags x "
                         f"{coal.NNZ} {dist} ids, r_blk {coal.R_BLK}, "
                         f"{coal.TILE_BAGS} bags a tile",
                   max_abs_err=err, tol=tol, k1_max_abs_err=k1_err,
                   bound_ms=b_ms, bound_by=b_by,
                   unique_rows=uniq, blocks=blocks, bytes=nbytes,
                   gbps=nbytes / rec["ms"] / 1e6)
        k10[dist] = rec
        say(f"phase 19 K10 {dist}: {rec['shape']}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}), K1 at these ids {k1_err:.3e} | "
            f"{timing_text(rec, 'F.embedding_bag')} | K1 "
            f"{fmt(rec['t_k1'])} | pre-pass + K10 "
            f"{fmt(rec['t_with_prepass'])} | {uniq} distinct rows in "
            f"{blocks} blocks of {coal.R_BLK} | bound {b_ms:.4f} ms "
            f"({b_by}) | {smi}")
        del idx, ids, longs, plans, want
    del ctab
    torch.cuda.empty_cache()

    # the main path: the headline bench and the experiment, as a user runs
    # them, with the launch counts reset just before and read just after
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rcs = [port_bench.main([]), coal.main(["--verify"]), coal.main([])]
    wall = time.perf_counter() - t0
    main19 = {k: v for k, v in kernels.launch_counts.items() if v}
    out19 = buf.getvalue()
    lines = out19.splitlines()
    bench_lines = [ln for ln in lines if ln.startswith("{")]
    bench_rec = json.loads(bench_lines[0]) if bench_lines else {}
    missing = [k for k in ("emb_gather", "desc_fetch", "coalesced_bag")
               if main19.get(k, 0) <= 0]
    k_lines = [ln for ln in lines if ln.strip().startswith("K=")]
    verdicts = [ln for ln in lines if " -> " in ln]
    if any(rcs) or missing or len(bench_lines) != 1 or \
            bench_rec.get("metric") != "torch_emb_lookup_bw_1Mx128_b8192_nnz30" \
            or not (math.isfinite(bench_rec.get("value", math.nan))
                    and bench_rec["value"] > 0) \
            or len(k_lines) != len(coal.KS) or len(verdicts) != 2 \
            or "verify: both kernels match" not in out19:
        fail(f"phase 19 bench / experiment: rcs {rcs}, not launched "
             f"{missing} ({main19}), output:\n{out19}")
    say(f"phase 19 param_tpu_torch.bench.main() and experiments.coalesce."
        f"main() (--verify, then stages A and B) | {wall:.1f} s | launches "
        f"{main19} | {smi}\n{out19.rstrip()}")
    result["phases"]["coalesce"] = dict(k9=k9, k9_fault=k9_fault, k10=k10,
                                        main_launches=main19, bench=bench_rec,
                                        output=out19, wall_s=wall)

    # ---------------------------------------------------------------- 20
    dlrm20 = sharded_dlrm(smi, breakdown)
    if cards >= 2:
        dlrm20["torchrun"] = dlrm_world(
            cards, smi, {o: result["phases"]["trainer"][o]["losses"][0]
                         for o in DLRM_OPTS})
    else:
        say("phase 20: one card: the sharded DLRM ran as a world of one; "
            "the all-to-alls and all-reduces between cards are unchecked")
    result["phases"]["sharded_dlrm"] = dlrm20
    main20 = dlrm20["launches"]

    # ---------------------------------------------------------------- 21
    par21 = parallel_tier(smi, breakdown)
    if cards >= 2:
        par21["torchrun"] = parallel_world(cards, smi)
    else:
        say("phase 21: one card: the parallel tier ran as a world of one "
            "and its shard schedules in one process; the KV ring, the "
            "all-to-alls, the tp all-reduces and the pipeline hops between "
            "cards are unchecked")
    result["phases"]["parallel_tier"] = par21
    main21 = [par21[key] for key in ("ring_world1", "tp_world1", "pp_world1")]

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

    def main_path_flash(runs, kernel, path="wgmma"):
        """Launches of ``kernel`` in the main path's runs, all of which
        must have taken ``path``."""
        total = sum(r["launches"].get(kernel, 0) for r in runs)
        on_path = sum(r["launches"].get(f"{kernel}_{path}", 0) for r in runs)
        if on_path != total:
            fail(f"{kernel}: {total - on_path} of {total} launches on the "
                 f"main path did not take the {path} path")
        return on_path

    k6_launches = main_path_flash([serve_runs["attention_llama2"],
                                   serve_runs["transformer_llama2"]],
                                  "flash_fwd")
    k7_launches = main_path_flash([train_runs["attention_llama2_grad"],
                                   train_runs["transformer_llama2_train"]],
                                  "flash_bwd")
    f32_runs = [serve_runs["attention_llama2_f32"],
                serve_runs["attention_gpt2_f32"],
                train_runs["attention_llama2_f32_grad"]]
    k6_f32_launches = main_path_flash(f32_runs, "flash_fwd", "tf32x3")
    k7_f32_launches = main_path_flash(f32_runs, "flash_bwd", "tf32x3")
    k6_par_launches = main_path_flash(main21, "flash_fwd")
    k7_par_launches = main_path_flash(main21, "flash_bwd")
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
        entry("int4 gemm (K5), wgmma path", src + "int4_gemm.cu",
              "param_tpu/ops/matmul.py:196",
              cli_launches("inference_int4_K5", "int4_gemm_wgmma"),
              k5["(512, 4096, 4096)"]),
        entry("int4 gemm, serve decode step (K5), stream path",
              src + "int4_gemm.cu", "param_tpu/ops/matmul.py:196", n_stream,
              k5["(1, 4096, 12288)"]),
        entry("flash attention forward (K6), wgmma path",
              src + "flash_fwd.cu", "param_tpu/ops/attention.py:251",
              k6_launches, k6["llama2_causal"]),
        entry("flash attention backward (K7), wgmma path",
              src + "flash_bwd.cu", "param_tpu/ops/attention.py:809, :841",
              k7_launches, k7["llama2_causal"]),
        entry("flash attention forward f32 (K6), tf32x3 path",
              src + "flash_fwd.cu", "param_tpu/ops/attention.py:251",
              k6_f32_launches, k6["f32_llama2_causal"]),
        entry("flash attention backward f32 (K7), tf32x3 path",
              src + "flash_bwd.cu", "param_tpu/ops/attention.py:809, :841",
              k7_f32_launches, k7["f32_llama2_causal"]),
        entry("ring all-gather (K8a), memory route", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:55",
              ring_launches["ring_all_gather_memory"],
              k8_rows["all_gather n=8 64 MiB float32"]),
        entry("ring reduce-scatter (K8b), cluster route", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:112",
              ring_launches["ring_reduce_scatter_cluster"],
              k8_rows["reduce_scatter n=8 64 MiB float32"]),
        entry("ring reduce-scatter (K8b), memory route", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:112",
              ring_launches["ring_reduce_scatter_memory"],
              k8_rows["reduce_scatter n=8 64 MiB float32"]["memory_route"]),
        entry("ring copy, one rank (K8a-c at n = 1)", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:55, :112, :181",
              ring_launches["ring_all_gather_copy"]
              + ring_launches["ring_reduce_scatter_copy"]
              + ring_launches["ring_bidir_all_gather_copy"],
              k8_rows["all_gather n=1 64 MiB float32"]),
        entry("both-direction ring all-gather (K8c), memory route",
              src + "ring.cu", "param_tpu/ops/ring_collectives.py:181",
              ring_launches["ring_bidir_all_gather_memory"],
              k8_rows["bidir n=8 64 MiB float32"]),
        entry("loopback remote copy (K8d)", src + "ring.cu",
              "param_tpu/ops/ring_collectives.py:261",
              ring_launches["ring_loopback"],
              k8_rows["loopback n=1 64 MiB float32"]),
        entry("emb_gather, sharded DLRM (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185", main20["emb_gather"],
              k1["dlrm_f32"]),
        entry("sparse_update adagrad, sharded DLRM (K2)",
              src + "sparse_update.cu", "param_tpu/ops/sparse_update.py:117",
              main20["sparse_update_adagrad"], k2["adagrad"]),
        entry("sparse_update sgd, sharded DLRM (K2)", src + "sparse_update.cu",
              "param_tpu/ops/sparse_update.py:117",
              main20["sparse_update_sgd"], k2["sgd"]),
        entry("flash attention forward, parallel tier: ring attention, tp "
              "and pp steps (K6), wgmma path", src + "flash_fwd.cu",
              "param_tpu/ops/attention.py:251", k6_par_launches,
              k6["llama2_causal"]),
        entry("flash attention backward, parallel tier: tp and pp steps "
              "(K7), wgmma path", src + "flash_bwd.cu",
              "param_tpu/ops/attention.py:809, :841", k7_par_launches,
              k7["llama2_causal"]),
        entry("emb_gather, bench headline shape (K1)", src + "emb_gather.cu",
              "param_tpu/ops/embedding.py:185", main19["emb_gather"],
              k1["headline_f32"]),
    ] + [entry(f"desc_fetch k={k} (K9)", src + "coalesce.cu",
               "scripts/coalesce_experiment.py:55", main19["desc_fetch"],
               k9[k]) for k in coal.KS]
      + [entry(f"coalesced_bag {dist} ids (K10)", src + "coalesce.cu",
               "scripts/coalesce_experiment.py:162", main19["coalesced_bag"],
               k10[dist]) for dist in ("uniform", "zipf")]}
    result.update(report)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    say(smi)
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the full results as JSON to PATH")
    args = ap.parse_args()
    sys.exit(main(args.out))
