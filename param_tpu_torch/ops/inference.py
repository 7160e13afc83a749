"""MLP inference bench with quantized paths (port of
``param_tpu/ops/inference.py``).

- fp32 / bf16 / fp16: straight cast inference (:func:`mlp_forward`).
- int8: weight-only, per-output-column max-abs int8 weights with f32
  scales; a matmul of bf16 operands with f32 sums, scale and bias in f32.
- int4: weight-only, group-wise (g = 128) max-abs / 7 int4 weights.  The
  reference casts its int8 carriers to XLA's native ``s4``; PyTorch has no
  such matmul, so the port packs the carriers once into the nibble layout
  of :func:`~param_tpu_torch.ops.matmul.pack_int4` and every layer runs K5
  (:func:`~param_tpu_torch.ops.matmul.matmul_int4`) at any batch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from param_tpu_torch.ops.matmul import matmul, matmul_int4, pack_nibbles
from param_tpu_torch.ops.mlp import init_mlp, mlp_flops, mlp_forward


def quantize_weights_int8(params):
    """[(W, b)] -> [(W_int8, per-column f32 scales, b)]."""
    out = []
    for w, b in params:
        wf = w.float()
        absmax = wf.abs().amax(dim=0)
        scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        q = torch.clamp(torch.round(wf / scale), -127, 127)
        out.append((q.to(torch.int8), scale, b))
    return out


def mlp_forward_int8(qparams, x: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 inference: matmul of bf16 operands with f32 sums,
    then scale and bias in f32; each layer's output is rounded to bf16."""
    h = x
    for i, (qw, scale, b) in enumerate(qparams):
        y = matmul(h.to(torch.bfloat16), qw.to(torch.bfloat16),
                   out_dtype=torch.float32)
        h = (y * scale + b.float()).to(torch.bfloat16)
        if i < len(qparams) - 1:
            h = torch.relu(h)
    return h


def quantize_weights_int4(params, group: int = 128):
    """[(W, b)] -> [(W_int8 carrier in [-7, 7], group scales
    (din // g, dout) f32, b)], as the reference quantizes."""
    out = []
    for w, b in params:
        din, dout = w.shape
        g = min(group, din)
        wf = w.float().reshape(din // g, g, dout)
        absmax = wf.abs().amax(dim=1)
        scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
        q = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7)
        out.append((q.to(torch.int8).reshape(din, dout), scale, b))
    return out


def cast_int4_mlp(qparams):
    """int8 carriers -> nibble-packed (din // 2, dout) bytes, K5's layout;
    call once, ahead of the inference loop, so that
    :func:`mlp_forward_int4` does not pack them on every step (the
    reference casts its carriers to XLA's ``s4`` here)."""
    return [(pack_nibbles(q), s, b) for q, s, b in qparams]


pack_int4_mlp = cast_int4_mlp


def mlp_forward_int4(qparams, x: torch.Tensor) -> torch.Tensor:
    """Weight-only int4 inference: K5 for every layer (packed weights from
    :func:`cast_int4_mlp`, or raw carriers, packed here), f32 output, bias
    in f32, each layer's output rounded to bf16."""
    h = x
    for i, (q, scale, b) in enumerate(qparams):
        if q.shape[0] == h.shape[-1]:  # a (din, dout) carrier
            q = pack_nibbles(q)
        y = matmul_int4(h, q, scale, out_dtype=torch.float32)
        h = (y + b.float()).to(torch.bfloat16)
        if i < len(qparams) - 1:
            h = torch.relu(h)
    return h


def bench_inference(configs: Sequence[tuple], dtype: str = "float32",
                    iters: int = 8, reps: int = 2, device="cuda"):
    """Inference sweep over (layers, din, hidden, dout, batch) tuples;
    ``dtype`` int8 / int4 selects weight-only quantization.  Returns
    ``ComputeResult``s (latency of one forward, TF/s, QPS, roofline)."""
    from param_tpu_torch.ops.compute_bench import ComputeResult, _report
    from param_tpu_torch.utils.chip import detect_chip, matmul_roofline_tflops
    from param_tpu_torch.utils.device import resolve_device
    from param_tpu_torch.utils.dtypes import dtype_from_name
    from param_tpu_torch.utils.timer import time_ms

    dev = resolve_device(device)
    chip = detect_chip(dev)
    results = []
    for num_layers, din, hidden, dout, batch in configs:
        dims = [din] + [hidden] * (num_layers - 1) + [dout]
        gen = torch.Generator(device=dev).manual_seed(0)
        fp_params = init_mlp(gen, dims, torch.float32, device=dev)
        rng = np.random.default_rng(0)
        x32 = torch.from_numpy(rng.random((batch, din), dtype=np.float32)).to(dev)
        if dtype == "int8":
            params, fwd = quantize_weights_int8(fp_params), mlp_forward_int8
            x = x32.to(torch.bfloat16)
            peak = chip.bf16_flops / 1e12  # int8 weights ride the bf16 path
        elif dtype == "int4":
            params = cast_int4_mlp(quantize_weights_int4(fp_params))
            fwd, x = mlp_forward_int4, x32.to(torch.bfloat16)
            peak = chip.bf16_flops / 1e12
        else:
            dt = dtype_from_name(dtype)
            params = [(w.to(dt), b.to(dt)) for w, b in fp_params]
            fwd, x = mlp_forward, x32.to(dt)
            peak = matmul_roofline_tflops(chip, dtype)
        del fp_params
        with torch.no_grad():
            per = time_ms(lambda: fwd(params, x), iters, dev, reps=reps) / 1e3
        tf = mlp_flops(dims, batch, fwd_only=True) / per / 1e12
        results.append(_report(ComputeResult(
            op="mlp_infer", shape=(num_layers, din, hidden, dout, batch),
            lat_us=per * 1e6, tflops=tf, qps=batch / per,
            roofline_frac=tf / peak if peak else 0.0), dtype))
    return results
