"""Compute-tier bench runners: GEMM, EmbeddingBag, MLP (port of
``param_tpu/ops/compute_bench.py``).

Metric formulas as in the reference (after PARAM's ``pytorch_gemm.py``,
``pytorch_emb.py``, ``pytorch_linear.py``): TF/s = 2MNK / t; GB/s =
batch * nnz * dim * elem / t; QPS = batch / t; MLP TF/s = (2|6) *
sum(l_i * l_i+1) * batch / t; ``roofline_frac`` against the card's peak for
the dtype (:mod:`param_tpu_torch.utils.chip`).

Timing: CUDA events around ``iters`` calls after a warm-up, the median of
``reps`` such windows (:func:`param_tpu_torch.utils.timer.time_ms`).  The
reference perturbs its inputs at every step so that XLA cannot hoist the
work out of its timing loop; eager PyTorch hoists nothing, so inputs are
built once (the embedding bench cycles through a few precomputed shifts of
its index set, as the reference shifts its indices per step).  A failing
shape raises; nothing is skipped.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from param_tpu_torch.ops.embedding import embedding_bag, embedding_bytes
from param_tpu_torch.ops.matmul import (
    gemm_flops, matmul, matmul_pallas, matmul_weight_resident,
)
from param_tpu_torch.ops.mlp import init_mlp, make_optimizer, mlp_flops, \
    mlp_forward
from param_tpu_torch.utils.chip import detect_chip, matmul_roofline_tflops
from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.dtypes import dtype_from_name, dtype_size
from param_tpu_torch.utils.logger import ComputePerfMetrics, emit_metrics
from param_tpu_torch.utils.timer import time_ms

EMB_INDEX_SETS = 8  # shifted index sets cycled through by the emb bench


@dataclass
class ComputeResult:
    op: str
    shape: tuple
    lat_us: float
    tflops: float = 0.0
    gbs: float = 0.0
    qps: float = 0.0
    roofline_frac: float = 0.0


def _report(res: ComputeResult, dtype: str) -> ComputeResult:
    emit_metrics(ComputePerfMetrics(
        op=res.op, dtype=dtype, shape=list(res.shape), lat_us=res.lat_us,
        tflops=res.tflops, gbs=res.gbs, roofline_frac=res.roofline_frac))
    return res


def _rand(gen: torch.Generator, shape, dt, dev) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=dev) * 0.01).to(dt)


# ------------------------------------------------------------------- GEMM
def bench_gemm(shapes: List[tuple], dtype: str = "float32", iters: int = 16,
               reps: int = 2, use_pallas: bool = False,
               precision: str = "default", weight_resident: int = 0,
               device="cuda") -> List[ComputeResult]:
    """One result per (M, N, K): ``torch.matmul`` (:func:`matmul`), K3
    (``use_pallas``) or, with ``weight_resident=S``, K4 over S GEMMs that
    share one B, reported per GEMM.

    ``precision`` is accepted for the reference's command lines; both of its
    values mean full f32 here (PyTorch's default, pinned by
    :func:`resolve_device`)."""
    if precision not in ("default", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    dev = resolve_device(device)
    dt = dtype_from_name(dtype)
    peak = matmul_roofline_tflops(detect_chip(dev), dtype)
    results = []
    for m, n, k in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        b = _rand(gen, (k, n), dt, dev)
        if weight_resident:
            s = weight_resident
            a = _rand(gen, (s, m, k), dt, dev)
            per = time_ms(lambda: matmul_weight_resident(a, b), iters, dev,
                          reps=reps) / s
        else:
            a = _rand(gen, (m, k), dt, dev)
            if use_pallas:
                # K3 masks its own edges: blocks of the whole shape always
                # pass the reference's divisibility rule
                fn = lambda: matmul_pallas(a, b, block_m=m, block_n=n,  # noqa: E731
                                           block_k=k)
            else:
                fn = lambda: matmul(a, b)  # noqa: E731
            per = time_ms(fn, iters, dev, reps=reps)
        del a, b
        tf = gemm_flops(m, n, k) / (per / 1e3) / 1e12
        results.append(_report(ComputeResult(
            op="gemm", shape=(m, n, k), lat_us=per * 1e3, tflops=tf,
            roofline_frac=tf / peak if peak else 0.0), dtype))
    return results


# -------------------------------------------------------------- Embedding
def bench_emb(configs: List[tuple], dtype: str = "float32", iters: int = 8,
              reps: int = 2, distribution: str = "uniform",
              max_rows: Optional[int] = None,
              device="cuda") -> List[ComputeResult]:
    """One result per (rows, dim, nnz, batch): the sum-pooled lookup
    :func:`embedding_bag` (K1 on the card).  ``max_rows`` clamps tables that
    exceed device memory."""
    from param_tpu_torch.models.dlrm_data import gen_indices

    dev = resolve_device(device)
    dt = dtype_from_name(dtype)
    es = dtype_size(dt)
    chip = detect_chip(dev)
    results = []
    rng = np.random.default_rng(0)
    table_cache = {}
    for rows, dim, nnz, batch in configs:
        if max_rows:
            rows = min(rows, max_rows)
        if (rows, dim) not in table_cache:
            table_cache.clear()  # one big table at a time
            if rows * dim * 4 > 1 << 30:
                # EMB_A's 14M / 26M x 128 tables (7-13 GB) are made on the
                # card: a host-made table that size takes minutes to copy
                gen = torch.Generator(device=dev).manual_seed(rows % 7919)
                table = torch.rand((rows, dim), generator=gen, device=dev)
            else:
                table = torch.from_numpy(
                    rng.random((rows, dim), dtype=np.float32)).to(dev)
            table_cache[(rows, dim)] = table.to(dt)
        table = table_cache[(rows, dim)]
        idx = torch.from_numpy(
            gen_indices(rng, batch, 1, nnz, rows, distribution)[:, 0, :]
        ).to(dev)
        idx_sets = [((idx + i) % rows).to(torch.int32)
                    for i in range(EMB_INDEX_SETS)]
        sets = itertools.cycle(idx_sets)
        with torch.no_grad():
            per = time_ms(lambda: embedding_bag(table, next(sets)), iters, dev,
                          reps=reps) / 1e3
        gbs = embedding_bytes(batch, nnz, dim, es) / per / 1e9
        results.append(_report(ComputeResult(
            op="emb", shape=(rows, dim, nnz, batch), lat_us=per * 1e6,
            gbs=gbs, qps=batch / per, roofline_frac=gbs / chip.hbm_gbs),
            dtype))
    return results


# -------------------------------------------------------------------- MLP
def bench_mlp(configs: List[tuple], dtype: str = "float32",
              optimizer: str = "sgd", fwd_only: bool = False,
              iters: int = 8, reps: int = 2,
              device="cuda") -> List[ComputeResult]:
    """One result per (layers, din, hidden, dout, batch): a forward
    (``fwd_only``) or a train step (MSE loss, backward, ``optimizer``)."""
    dev = resolve_device(device)
    dt = dtype_from_name(dtype)
    peak = matmul_roofline_tflops(detect_chip(dev), dtype)
    results = []
    for num_layers, din, hidden, dout, batch in configs:
        dims = [din] + [hidden] * (num_layers - 1) + [dout]
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_mlp(gen, dims, dt, device=dev)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.random((batch, din), dtype=np.float32)).to(
            dev, dt)
        y = torch.from_numpy(rng.random((batch, dout), dtype=np.float32)).to(dev)
        if fwd_only:
            def step():
                with torch.no_grad():
                    return mlp_forward(params, x)
        else:
            for w, b in params:
                w.requires_grad_(True)
                b.requires_grad_(True)
            opt = make_optimizer(optimizer)
            state = opt.init(params)
            leaves = [t for wb in params for t in wb]

            def step():
                loss = torch.mean((mlp_forward(params, x).float() - y) ** 2)
                grads = torch.autograd.grad(loss, leaves)
                opt.update(params, grads, state)
                return loss

        per = time_ms(step, iters, dev, reps=reps) / 1e3
        tf = mlp_flops(dims, batch, fwd_only) / per / 1e12
        results.append(_report(ComputeResult(
            op="mlp", shape=(num_layers, din, hidden, dout, batch),
            lat_us=per * 1e6, tflops=tf, qps=batch / per,
            roofline_frac=tf / peak if peak else 0.0), dtype))
    return results


def print_results(results: List[ComputeResult], dtype: str,
                  device="cuda") -> None:
    chip = detect_chip(device)
    print(f"\nCOMPUTE-RES chip={chip.name} dtype={dtype}")
    print(f"{'op':>6}{'shape':>30}{'lat(us)':>14}{'TF/s':>12}{'GB/s':>10}"
          f"{'QPS':>14}{'roofline':>10}")
    for r in results:
        print(f"{r.op:>6}{str(r.shape):>30}{r.lat_us:>14.1f}{r.tflops:>12.2f}"
              f"{r.gbs:>10.1f}{r.qps:>14.0f}{r.roofline_frac:>9.1%}")
