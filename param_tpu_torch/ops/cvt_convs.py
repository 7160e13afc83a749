"""CvT convolution benchmarks: token-embedding and projection layers (port
of ``param_tpu/ops/cvt_convs.py``).

Counterpart of ``train/compute/pt/pytorch_cvt_convs.py``:

- :func:`conv_projection`: CvT's convolutional projection
  (pytorch_cvt_convs.py:52-96): depthwise 3x3 conv + train-mode batchnorm
  + ``b c h w -> b (hw) c`` (method ``dw_bn``), or ceil-mode average pool +
  rearrange (method ``avg``).
- :func:`patch_embed`: convolutional token embedding
  (pytorch_cvt_convs.py:108-139): full conv + LayerNorm over channels.
- :data:`CVT_CONFIGS`: the 11 paper-exact layer configs
  (pytorch_cvt_convs.py:240-381), inputs as CvT trained them (batch 32).
- :func:`bench_cvt`: forward, or forward + backward, timed by CUDA events
  (``perf_counter`` on the CPU), with the reference's FLOP model
  (:175-210) beside an honest conv FLOP count.

Inputs are NHWC, as in the JAX package; weights are OIHW (the JAX
package's HWIO transposed; a depthwise kernel (C, 1, kh, kw)), and the
convolutions run as ``F.conv2d`` on the channels-last NCHW view (cuDNN on
the card: they are XLA convolutions in the JAX package).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.timer import time_ms


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


# --------------------------------------------------------------- layers
def depthwise_conv(x, w, stride: int, padding: int):
    """NHWC depthwise conv, one filter per channel
    (reference nn.Conv2d(groups=dim_in), pytorch_cvt_convs.py:60-70);
    ``w``: (C, 1, kh, kw)."""
    return _nhwc(F.conv2d(_nchw(x), w, None, stride, padding,
                          groups=x.shape[-1]))


def conv2d(x, w, stride: int, padding: int):
    """NHWC full conv; ``w``: (Cout, Cin, kh, kw)."""
    return _nhwc(F.conv2d(_nchw(x), w, None, stride, padding))


def batch_norm(x, gamma, beta, eps: float = 1e-5):
    """Training-mode batchnorm over (N, H, W) per channel, biased variance
    (reference nn.BatchNorm2d in train mode)."""
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the channel axis (reference norm_layer=nn.LayerNorm
    applied to ``b (hw) c``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def avg_pool(x, kernel_size: int, stride: int, padding: int):
    """Ceil-mode AvgPool2d with ``count_include_pad`` (reference
    method='avg', pytorch_cvt_convs.py:71-88): the zero padding counts in
    the divisor, the ceil-mode extension past it does not.  The output size
    is the JAX package's, ``ceil((n + 2p - k) / s) + 1``, which keeps a
    last window that starts in the right padding (``F.avg_pool2d`` drops
    it)."""
    n, h, w, c = x.shape

    def extra(size):
        out = -(-(size + 2 * padding - kernel_size) // stride) + 1
        return max(0, (out - 1) * stride + kernel_size - size - 2 * padding)

    ext_h, ext_w = extra(h), extra(w)
    xs = F.pad(_nchw(x), (padding, padding + ext_w, padding, padding + ext_h))
    ones = torch.ones((1, 1, h + 2 * padding, w + 2 * padding),
                      dtype=x.dtype, device=x.device)
    counts = F.pad(ones, (0, ext_w, 0, ext_h))
    summed = F.avg_pool2d(xs, kernel_size, stride, divisor_override=1)
    div = F.avg_pool2d(counts, kernel_size, stride, divisor_override=1)
    return _nhwc(summed / div)


def init_conv_projection(generator: torch.Generator, dim_in: int,
                         kernel_size: int, method: str = "dw_bn",
                         device="cuda"):
    """Depthwise kernel (dim_in, 1, k, k) ~ N(0, 0.1^2) drawn from
    ``generator`` (on the host), batchnorm scale 1 and shift 0, on
    ``device`` (default the card, through ``resolve_device``)."""
    device = resolve_device(device)
    if method == "avg":
        return {}
    w = torch.randn((dim_in, 1, kernel_size, kernel_size),
                    generator=generator) * 0.1
    return {"w": w.to(device),
            "gamma": torch.ones(dim_in, device=device),
            "beta": torch.zeros(dim_in, device=device)}


def conv_projection(params, x, *, kernel_size: int, padding: int,
                    stride: int, method: str = "dw_bn"):
    """CvT conv projection: NHWC in -> (B, H'*W', C) tokens out."""
    if method == "dw_bn":
        y = depthwise_conv(x, params["w"], stride, padding)
        y = batch_norm(y, params["gamma"], params["beta"])
    elif method == "avg":
        y = avg_pool(x, kernel_size, stride, padding)
    else:
        raise ValueError(f"unknown method {method!r}")
    b, h, w, c = y.shape
    return y.reshape(b, h * w, c)  # b c h w -> b (hw) c in NHWC


def init_patch_embed(generator: torch.Generator, in_chans: int,
                     embed_dim: int, patch_size: int, device="cuda"):
    """Conv kernel (embed_dim, in_chans, p, p) ~ N(0, 1 / (in_chans p^2))
    from ``generator`` (on the host), bias 0, LayerNorm scale 1, shift 0,
    on ``device`` (default the card, through ``resolve_device``)."""
    device = resolve_device(device)
    w = torch.randn((embed_dim, in_chans, patch_size, patch_size),
                    generator=generator) * (
        1.0 / np.sqrt(in_chans * patch_size * patch_size))
    return {"w": w.to(device),
            "b": torch.zeros(embed_dim, device=device),
            "gamma": torch.ones(embed_dim, device=device),
            "beta": torch.zeros(embed_dim, device=device)}


def patch_embed(params, x, *, stride: int, padding: int, norm: bool = True):
    """Convolutional token embedding: conv + channel LayerNorm, returned in
    image layout (NHWC) like the reference (rearranged back)."""
    y = conv2d(x, params["w"], stride, padding) + params["b"]
    if norm:
        b, h, w, c = y.shape
        t = layer_norm(y.reshape(b, h * w, c), params["gamma"],
                       params["beta"])
        y = t.reshape(b, h, w, c)
    return y


# --------------------------------------------------------------- configs
@dataclass
class CvtLayerCfg:
    """One reference benchmark entry (pytorch_cvt_convs.py:247-381).
    ``input_shape`` is NCHW like the reference prints it."""

    name: str
    layer_type: str  # conv_proj | patch_embed
    input_shape: Tuple[int, int, int, int]
    kwargs: Dict


def _proj(stage: str, qk: str, shape, dim: int, stride: int) -> CvtLayerCfg:
    return CvtLayerCfg(f"cvt.{stage}.conv_proj_{qk}", "conv_proj", shape,
                       dict(dim_in=dim, dim_out=dim, kernel_size=3, padding=1,
                            stride=stride, method="dw_bn"))


CVT_CONFIGS: List[CvtLayerCfg] = [
    _proj(stage, qk, shape, shape[1], 1 if qk == "q" else 2)
    for stage, shape in (("stage0.block0", (32, 64, 56, 56)),
                         ("stage1.block0", (32, 192, 28, 28)),
                         ("stage1.block1", (32, 192, 28, 28)),
                         ("stage2.blocks0", (32, 384, 14, 14)))
    for qk in ("q", "k")
] + [
    CvtLayerCfg("cvt.stage0.patch_embed", "patch_embed", (32, 3, 224, 224),
                dict(patch_size=7, in_chans=3, embed_dim=64, stride=4,
                     padding=2)),
    CvtLayerCfg("cvt.stage1.patch_embed", "patch_embed", (32, 64, 56, 56),
                dict(patch_size=3, in_chans=64, embed_dim=192, stride=2,
                     padding=1)),
    CvtLayerCfg("cvt.stage2.patch_embed", "patch_embed", (32, 192, 28, 28),
                dict(patch_size=3, in_chans=192, embed_dim=384, stride=2,
                     padding=1)),
]


def reference_flops(cfg: CvtLayerCfg) -> Tuple[float, float]:
    """(reference FLOP model, honest conv FLOPs).

    The reference model (pytorch_cvt_convs.py:175-210) counts
    (n+1)*instances*batch with instances computed from input_shape[1:3]
    (note: it indexes channels as 'rows' for conv_proj; reproduced
    verbatim for comparability).  The honest count is
    2*out_positions*k^2*cin_per_group*cout*batch."""
    n_, c, h, w = cfg.input_shape
    kw = cfg.kwargs
    if cfg.layer_type == "conv_proj":
        k, cin, cout = kw["kernel_size"], kw["dim_in"], kw["dim_out"]
        groups = cin
    else:
        k, cin, cout = kw["patch_size"], kw["in_chans"], kw["embed_dim"]
        groups = 1
    stride, padding = kw["stride"], kw["padding"]
    # reference formula, verbatim semantics (input_shape[1], [2])
    inst = (((cfg.input_shape[1] - k + 2 * padding) / stride) + 1) * (
        ((cfg.input_shape[2] - k + 2 * padding) / stride) + 1)
    ref = (cin * k * k + 1) * inst * n_
    # honest: output spatial positions from H, W
    oh = (h - k + 2 * padding) // stride + 1
    ow = (w - k + 2 * padding) // stride + 1
    honest = 2.0 * n_ * oh * ow * k * k * (cin // groups) * cout
    return ref, honest


# --------------------------------------------------------------- bench
def make_layer(cfg: CvtLayerCfg, generator: torch.Generator, device="cuda"):
    """(params, fn(params, x)) of one config, the parameters on
    ``device``."""
    kw = cfg.kwargs
    if cfg.layer_type == "conv_proj":
        params = init_conv_projection(
            generator, kw["dim_in"], kw["kernel_size"],
            kw.get("method", "dw_bn"), device)
        fn = functools.partial(
            conv_projection, kernel_size=kw["kernel_size"],
            padding=kw["padding"], stride=kw["stride"],
            method=kw.get("method", "dw_bn"))
    else:
        params = init_patch_embed(
            generator, kw["in_chans"], kw["embed_dim"], kw["patch_size"],
            device)
        fn = functools.partial(
            patch_embed, stride=kw["stride"], padding=kw["padding"])
    return params, fn


def layer_inputs(cfg: CvtLayerCfg, index: int, dtype=torch.float32,
                 device="cuda"):
    """(params, fn, x NHWC, g) of ``cfg`` as ``bench_cvt`` makes them for
    its ``index``-th config, on ``device`` (default the card, through
    ``resolve_device``): parameters from a generator seeded ``index``, x
    and the output cotangent g from numpy's ``default_rng(index)`` (the
    JAX package's draws, bit for bit)."""
    device = resolve_device(device)
    n_, c, h, w = cfg.input_shape
    params, fn = make_layer(cfg, torch.Generator().manual_seed(index), device)
    params = {k: v.to(dtype) for k, v in params.items()}
    rng = np.random.default_rng(index)
    x = torch.from_numpy(rng.random((n_, h, w, c), dtype=np.float32)).to(
        device=device, dtype=dtype)
    with torch.no_grad():
        shape = fn(params, x).shape
    g = torch.from_numpy(rng.random(tuple(shape), dtype=np.float32)).to(
        device=device, dtype=dtype)
    return params, fn, x, g


def layer_call(cfg: CvtLayerCfg, index: int, forward_only: bool,
               dtype=torch.float32, device="cuda"):
    """The call ``bench_cvt`` times for its ``index``-th config: the
    forward under ``no_grad``, or forward + ``autograd.grad`` of
    sum(y * g) with respect to the parameters and x."""
    params, fn, x, g = layer_inputs(cfg, index, dtype, device)
    if forward_only:
        def call():
            with torch.no_grad():
                return fn(params, x)
    else:
        def call():
            ps = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
            xx = x.detach().requires_grad_(True)
            y = fn(ps, xx)
            loss = (y.float() * g.float()).sum()
            return torch.autograd.grad(loss, list(ps.values()) + [xx])
    return call


def bench_cvt(
    configs: Optional[List[CvtLayerCfg]] = None,
    forward_only: bool = False,
    dtype=torch.float32,
    steps: int = 8,
    max_calls: int = 64,
    reps: int = 3,
    device="cuda",
) -> List[Dict]:
    """Time each CvT layer: ``min(steps, max_calls)`` calls a window
    between CUDA events, median of ``reps`` windows after an untimed one.
    Forward + backward by default like the reference (run(),
    pytorch_cvt_convs.py:160-172: forward + ``.backward`` with a fixed
    grad_output): ``autograd.grad`` of sum(y * g) with respect to the
    parameters and x."""
    dev = resolve_device(device)
    calls = max(1, min(steps, max_calls))
    results = []
    for ci, cfg in enumerate(configs or CVT_CONFIGS):
        call = layer_call(cfg, ci, forward_only, dtype, dev)
        per = time_ms(call, calls, dev, reps=reps) / 1e3
        ref_flops, honest_flops = reference_flops(cfg)
        if not forward_only:
            honest_flops *= 3  # bwd ~ 2x fwd conv FLOPs
        results.append({
            "name": cfg.name,
            "layer_type": cfg.layer_type,
            "input_shape": list(cfg.input_shape),
            "elap_s": per,
            "ref_flops": ref_flops,
            "tflops": honest_flops / per / 1e12,
            "ref_tfs": ref_flops / per / 1e12,
        })
    return results


def report(results: List[Dict]) -> None:
    print(f"CVT-RES {'layer':<36}{'input(NCHW)':>20}{'elap(us)':>12}"
          f"{'TF/s':>9}{'ref-TF/s':>10}")
    for r in results:
        shape = "x".join(str(s) for s in r["input_shape"])
        print(f"CVT-RES {r['name']:<36}{shape:>20}{r['elap_s']*1e6:>12.1f}"
              f"{r['tflops']:>9.2f}{r['ref_tfs']:>10.2f}")
