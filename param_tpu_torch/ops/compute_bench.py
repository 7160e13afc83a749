"""Compute-tier bench runners: GEMM, EmbeddingBag, MLP, attention, decode,
block serving and the transformer block (port of
``param_tpu/ops/compute_bench.py``).

Metric formulas as in the reference (after PARAM's ``pytorch_gemm.py``,
``pytorch_emb.py``, ``pytorch_linear.py``): TF/s = 2MNK / t; GB/s =
batch * nnz * dim * elem / t; QPS = batch / t; MLP TF/s = (2|6) *
sum(l_i * l_i+1) * batch / t; attention TF/s from the causal-aware
:func:`~param_tpu_torch.ops.attention.attention_flops`; decode and serve
GB/s from the KV (and weight) bytes a step must read; ``roofline_frac``
against the card's peak for the dtype (:mod:`param_tpu_torch.utils.chip`).

Timing: CUDA events around ``iters`` calls after a warm-up, the median of
``reps`` such windows (:func:`param_tpu_torch.utils.timer.time_ms`).  The
reference perturbs its inputs at every step so that XLA cannot hoist the
work out of its timing loop; eager PyTorch hoists nothing, so inputs are
built once (the embedding bench cycles through a few precomputed shifts of
its index set, as the reference shifts its indices per step).  A failing
shape raises; nothing is skipped.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from param_tpu_torch.models import transformer as tfm
from param_tpu_torch.ops.attention import (
    attention_flops, decode_attention, flash_attention, flash_mha,
    make_attention,
)
from param_tpu_torch.ops.embedding import embedding_bag, embedding_bytes
from param_tpu_torch.ops.matmul import (
    gemm_flops, matmul, matmul_pallas, matmul_weight_resident,
)
from param_tpu_torch.ops.mlp import (
    infer_step, init_mlp, make_optimizer, make_train_step, mlp_flops,
)
from param_tpu_torch.utils.chip import (
    attention_roofline_tflops, detect_chip, matmul_roofline_tflops,
)
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
                return infer_step(params, x)
        else:
            opt = make_optimizer(optimizer)
            train_step, state = make_train_step(opt), opt.init(params)

            def step():
                return train_step(params, state, x, y)[2]

        per = time_ms(step, iters, dev, reps=reps) / 1e3
        tf = mlp_flops(dims, batch, fwd_only) / per / 1e12
        results.append(_report(ComputeResult(
            op="mlp", shape=(num_layers, din, hidden, dout, batch),
            lat_us=per * 1e6, tflops=tf, qps=batch / per,
            roofline_frac=tf / peak if peak else 0.0), dtype))
    return results


# -------------------------------------------------------------- attention
def _randn(gen: torch.Generator, shape, dt, dev) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=dev) * 0.1).to(dt)


def bench_attention(shapes: List[tuple], dtype: str = "bfloat16",
                    causal: bool = True, paths: Optional[List[str]] = None,
                    iters: int = 16, reps: int = 2, block_q: int = 1024,
                    block_k: int = 1024, grad: bool = False,
                    device="cuda") -> List[ComputeResult]:
    """One result per (batch, heads, seq, head_dim) and path: 'xla' (the
    unfused :func:`mha_reference`), 'flash' (K6), 'dpa'
    (``F.scaled_dot_product_attention``).  TF/s from the causal-aware flop
    count.  ``grad``: each call is a forward and a backward, the gradients
    of q, k and v of sum(op(q, k, v)) as the reference's objective, through
    autograd ('flash' through :func:`flash_mha`, K6 then K7); the flops are
    7/2 of the forward's (2 products forward, 5 backward)."""
    dev = resolve_device(device)
    dt = dtype_from_name(dtype)
    peak = attention_roofline_tflops(detect_chip(dev), dtype)
    results = []
    for b, h, s, d in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (_randn(gen, (b, h, s, d), dt, dev) for _ in range(3))
        for path in paths or ["xla", "flash"]:
            if grad:
                op = (functools.partial(flash_mha, causal=causal)
                      if path == "flash" else make_attention(path,
                                                             causal=causal))
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

                def call(op=op, leaves=leaves):
                    out = op(*leaves)
                    return torch.autograd.grad(out.float().sum(), leaves)

                per = time_ms(call, iters, dev, reps=reps) / 1e3
                del leaves
            else:
                if path == "flash":
                    op = functools.partial(flash_attention, causal=causal,
                                           block_q=block_q, block_k=block_k)
                else:
                    op = make_attention(path, causal=causal)
                with torch.no_grad():
                    per = time_ms(lambda: op(q, k, v), iters, dev,
                                  reps=reps) / 1e3
            fl = attention_flops(b, h, s, s, d, causal)
            if grad:
                fl = fl * 7 // 2
            tf = fl / per / 1e12
            results.append(_report(ComputeResult(
                op=f"att{'-grad' if grad else ''}:{path}", shape=(b, h, s, d),
                lat_us=per * 1e6, tflops=tf,
                roofline_frac=tf / peak if peak else 0.0), dtype))
        del q, k, v
    return results


def bench_decode_attention(shapes: List[tuple], dtype: str = "bfloat16",
                           iters: int = 16, reps: int = 2,
                           device="cuda") -> List[ComputeResult]:
    """One result per (batch, heads, kv_len, head_dim), or (batch, heads,
    kv_heads, kv_len, head_dim) for GQA: the decode step's attention
    (:func:`decode_attention`, plain PyTorch as the reference's is plain
    XLA).  GB/s of K+V bytes, against the card's memory rate."""
    dev = resolve_device(device)
    dt = dtype_from_name(dtype)
    hbm = detect_chip(dev).hbm_gbs
    results = []
    for shape in shapes:
        if len(shape) == 5:
            b, h, h_kv, s, d = shape
        else:
            b, h, s, d = shape
            h_kv = h
        gen = torch.Generator(device=dev).manual_seed(0)
        q = _randn(gen, (b, h_kv, h // h_kv, d), dt, dev)
        k = _randn(gen, (b, h_kv, s, d), dt, dev)
        v = _randn(gen, (b, h_kv, s, d), dt, dev)
        with torch.no_grad():
            per = time_ms(lambda: decode_attention(q, k, v), iters, dev,
                          reps=reps) / 1e3
        gbs = 2 * b * h_kv * s * d * dtype_size(dt) / per / 1e9
        results.append(_report(ComputeResult(
            op="decode" if h == h_kv else "decode-gqa", shape=tuple(shape),
            lat_us=per * 1e6, gbs=gbs, qps=b / per,
            roofline_frac=gbs / hbm), dtype))
        del q, k, v
    return results


def weight_bytes(params) -> int:
    """Bytes a decode step streams for the four matmul weights: packed
    nibbles or int8 values plus their scales, or the plain matrices."""
    total = 0
    for key in tfm.MATMUL_WEIGHTS:
        w = params[key]
        if isinstance(w, tuple):
            total += sum(t.numel() * t.element_size() for t in w
                         if isinstance(t, torch.Tensor))
        else:
            total += w.numel() * w.element_size()
    return total


def bench_block_decode(shapes: List[tuple], dtype: str = "bfloat16",
                       iters: int = 16, reps: int = 2,
                       device="cuda") -> List[ComputeResult]:
    """One result per (batch, cache_len, emb, heads, ffn), or with a
    kv_heads slot before ffn for GQA: a whole-block decode step
    (:func:`~param_tpu_torch.models.transformer.decode_step`) on a cache
    filled to ``cache_len - 2`` by an unfused prefill of half of it.
    ``dtype`` int8 / int4 selects weight-only quantization (activations
    and KV stay bf16; int4 weights are packed once and run K5).  GB/s of
    weight + KV bytes per step, against the card's memory rate."""
    dev = resolve_device(device)
    quant = dtype in ("int8", "int4")
    act_dtype = "bfloat16" if quant else dtype
    dt = dtype_from_name(act_dtype)
    hbm = detect_chip(dev).hbm_gbs
    results = []
    for shape in shapes:
        if len(shape) == 6:
            b, cache_len, e, h, kvh, ff = shape
        else:
            b, cache_len, e, h, ff = shape
            kvh = h
        cfg = tfm.TransformerConfig(batch=b, seq=1, emb=e, heads=h, ffn=ff,
                                    attention="xla", dtype=act_dtype,
                                    kv_heads=kvh)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = tfm.init_params(gen, cfg, dev)
        prompt = _randn(gen, (b, cache_len // 2, e), dt, dev)
        with torch.no_grad():
            _, cache = tfm.prefill(
                params, prompt, tfm.TransformerConfig(
                    batch=b, seq=cache_len // 2, emb=e, heads=h, ffn=ff,
                    attention="xla", dtype=act_dtype, kv_heads=kvh),
                cache_len)
        del prompt
        if dtype == "int8":
            params = tfm.quantize_block_weights_int8(params)
        elif dtype == "int4":
            # packed once, ahead of the decode loop
            params = tfm.cast_int4_params(
                tfm.quantize_block_weights_int4(params))
        x1 = _randn(gen, (b, 1, e), dt, dev)
        pos = cache_len - 2  # a near-full cache: the most KV to read
        with torch.no_grad():
            per = time_ms(lambda: tfm.decode_step(params, cache, x1, pos, cfg),
                          iters, dev, reps=reps) / 1e3
        kv_bytes = 2 * b * kvh * cfg.head_dim * cache_len * dtype_size(dt)
        gbs = (weight_bytes(params) + kv_bytes) / per / 1e9
        results.append(_report(ComputeResult(
            op=f"serve-{dtype}" if quant else "serve", shape=tuple(shape),
            lat_us=per * 1e6, gbs=gbs, qps=b / per, roofline_frac=gbs / hbm),
            dtype))
        del params, cache
    return results


def transformer_block_flops(b: int, s: int, e: int, h: int, ff: int,
                            causal: bool = True, grad: bool = True) -> int:
    """Matmul flops of one pre-LN block step (LN and gelu excluded): QKV
    (E -> 3E), attention, output projection, the FFN; training counts the
    projections' backward as 2x and attention's as 5/2x."""
    proj = 2 * b * s * (e * 3 * e + e * e + 2 * e * ff)
    att = attention_flops(b, h, s, s, e // h, causal)
    if grad:
        return 3 * proj + att * 7 // 2
    return proj + att


def bench_transformer(shapes: List[tuple], dtype: str = "bfloat16",
                      causal: bool = True, paths: Optional[List[str]] = None,
                      iters: int = 8, reps: int = 2, grad: bool = True,
                      lr: float = 1e-4,
                      device="cuda") -> List[ComputeResult]:
    """One result per (batch, seq, emb, heads, ffn) and attention path
    ('flash': K6, and K7 when training; 'xla': unfused).  ``grad``: each
    timed call is one train step of
    :func:`~param_tpu_torch.models.transformer.make_train_step` (loss
    mean(out^2), backward, SGD at ``lr``), the params carried from step to
    step as the reference's scan carries them; else the block forward and
    the objective under ``no_grad``.  TF/s from
    :func:`transformer_block_flops`."""
    dev = resolve_device(device)
    dt = dtype_from_name(dtype)
    peak = matmul_roofline_tflops(detect_chip(dev), dtype)
    results = []
    for b, s, e, h, ff in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        x0 = _randn(gen, (b, s, e), dt, dev)
        for path in paths or ["flash", "xla"]:
            cfg = tfm.TransformerConfig(batch=b, seq=s, emb=e, heads=h,
                                        ffn=ff, causal=causal, attention=path,
                                        dtype=dtype)
            state = {"params": tfm.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg, dev)}
            if grad:
                train_step = tfm.make_train_step(cfg, lr=lr)

                def step(state=state, train_step=train_step):
                    state["params"], loss = train_step(state["params"], x0)
                    return loss

                per = time_ms(step, iters, dev, reps=reps) / 1e3
            else:
                def step(state=state, cfg=cfg):
                    out = tfm.block_apply(state["params"], x0, cfg)
                    return torch.mean(torch.square(out.float()))

                with torch.no_grad():
                    per = time_ms(step, iters, dev, reps=reps) / 1e3
            tf = transformer_block_flops(b, s, e, h, ff, causal,
                                         grad) / per / 1e12
            results.append(_report(ComputeResult(
                op=f"tf{'' if grad else '-fwd'}:{path}", shape=(b, s, e, h, ff),
                lat_us=per * 1e6, tflops=tf,
                roofline_frac=tf / peak if peak else 0.0), dtype))
            del state
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
