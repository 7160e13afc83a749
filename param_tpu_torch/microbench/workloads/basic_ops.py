"""Basic operator registrations (port of
``param_tpu/microbench/workloads/basic_ops.py``).

Counterpart of the reference's ``workloads/pytorch/native_basic_ops.py:8-37``.
Every name the JAX package registers (its ``jnp.*`` / ``nn.*`` names and its
``torch.*`` aliases) is registered here and computes what the JAX op
computes:

- ``jnp.gelu`` is ``jax.nn.gelu``'s default, the tanh approximation;
- the matmuls (``jnp.matmul`` / ``mm`` / ``bmm`` / ``baddbmm``) return f32
  for 16-bit operands (the JAX ops' ``preferred_element_type``): on the card
  ``torch.mm`` / ``torch.bmm`` with ``out_dtype=float32``, as
  ``ops/matmul.matmul(out_dtype=torch.float32)`` does;
- ``nn.Linear`` / ``nn.Conv2d`` are flax's ``Dense`` / ``Conv`` (NHWC
  inputs, ``"SAME"`` padding by default, asymmetric when a stride does not
  divide; parameters and inputs promoted to one dtype), the pools take NHWC
  and ``MaxPool2d`` pads with -inf;
- ``nn.sdpa`` takes (B, S, H, D) like ``jax.nn.dot_product_attention``;
- ``nn.Dropout`` draws its mask from a generator seeded 0 on the input's
  device (JAX's ``PRNGKey(0)`` mask cannot be reproduced): the same mask
  every call, the kept share 1 - p, kept entries x / (1 - p).

These are XLA ops in the JAX package (no Pallas kernel), so they are
PyTorch calls here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from param_tpu_torch.microbench.operator import (
    BuildableOp,
    CallableOp,
    UnaryOp,
    register_operators,
)

_HALF = (torch.bfloat16, torch.float16)


def _promoted(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


class Dense(torch.nn.Module):
    """flax ``nn.Dense``: ``y = x @ W + b`` over the last axis; ``weight``
    is (out, in), the transpose of flax's (in, out) kernel."""

    def __init__(self, din: int, dout: int, use_bias: bool = True):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(dout, din))
        self.bias = torch.nn.Parameter(torch.empty(dout)) if use_bias else None

    def forward(self, x):
        ps = [self.weight] + ([self.bias] if self.bias is not None else [])
        x, *ps = _promoted(x, *ps)
        return F.linear(x, *ps)


def _pairs(padding, kernel, strides, size):
    """flax padding -> ((lo, hi) along H, (lo, hi) along W)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        if padding.upper() != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        out = []
        for n, k, s in zip(size, kernel, strides):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple(tuple(p) for p in padding)


def _pad_nchw(x, pairs, value=0.0):
    (hl, hh), (wl, wh) = pairs
    if hl or hh or wl or wh:
        x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x


class Conv(torch.nn.Module):
    """flax ``nn.Conv`` on NHWC inputs: ``weight`` is OIHW (flax's HWIO
    kernel transposed), computed by ``F.conv2d`` on the channels-last NCHW
    view of the input, with flax's padding (``"SAME"``: asymmetric where a
    stride leaves an odd total)."""

    def __init__(self, in_ch: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1),
                 padding: Union[str, int, Sequence] = "SAME",
                 use_bias: bool = True):
        super().__init__()
        kh, kw = kernel_size
        self.weight = torch.nn.Parameter(torch.empty(features, in_ch, kh, kw))
        self.bias = (torch.nn.Parameter(torch.empty(features)) if use_bias
                     else None)
        self.strides = tuple(strides)
        self.padding = padding

    def forward(self, x):  # (N, H, W, C)
        w, b = self.weight, self.bias
        x, w, *b = _promoted(x, w, *([b] if b is not None else []))
        pairs = _pairs(self.padding, w.shape[2:], self.strides, x.shape[1:3])
        xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if all(lo == hi for lo, hi in pairs):
            y = F.conv2d(xc, w, b[0] if b else None, self.strides,
                         (pairs[0][0], pairs[1][0]))
        else:
            y = F.conv2d(_pad_nchw(xc, pairs), w, b[0] if b else None,
                         self.strides)
        return y.permute(0, 2, 3, 1)


def _linear_ctor(din, dout, use_bias=True):
    return Dense(din, dout, use_bias)


def _conv2d_ctor(in_ch, out_ch, kernel, stride=1, padding="SAME"):
    return Conv(in_ch, out_ch, (kernel, kernel), (stride, stride), padding)


def max_pool(x, window: Sequence[int], strides: Sequence[int],
             padding=((0, 0), (0, 0))):
    """NHWC max pool (flax ``nn.max_pool``); padding with -inf."""
    xc = x.permute(0, 3, 1, 2)
    xc = _pad_nchw(xc, padding, value=-math.inf)
    return F.max_pool2d(xc, tuple(window), tuple(strides)).permute(0, 2, 3, 1)


def _maxpool_ctor(kernel, stride=None, padding=0):
    """NHWC max pool (torch.nn.MaxPool2d analogue), -inf padding."""
    stride = stride or kernel
    pad = ((padding, padding), (padding, padding))
    return lambda x: max_pool(x, (kernel, kernel), (stride, stride), pad)


def _adaptive_avgpool_ctor(output_size):
    """NHWC adaptive average pool for the divisible case (the reference
    workloads use power-of-two sizes), cropping as the JAX op does."""
    oh = ow = output_size if isinstance(output_size, int) else output_size[0]

    def pool(x):
        n, h, w, c = x.shape
        kh, kw = h // oh, w // ow
        return x[:, : oh * kh, : ow * kw].reshape(
            n, oh, kh, ow, kw, c).mean(dim=(2, 4))

    return pool


def _relu_ctor():
    return F.relu


def _dropout_ctor(p=0.5):
    def drop(x):
        g = torch.Generator(device=x.device).manual_seed(0)
        keep = torch.rand(x.shape, generator=g, device=x.device) < 1 - p
        return torch.where(keep, x / (1 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device)
                           ).to(x.dtype)

    return drop


def _f32_out(a, b) -> bool:
    """16-bit operands of one dtype on the card: cuBLAS writes the f32 sums."""
    return a.device.type == "cuda" and a.dtype in _HALF and b.dtype == a.dtype


class _MmF32(torch.autograd.Function):
    """``torch.mm`` / ``torch.bmm`` of 16-bit operands with ``out_dtype=
    float32`` (which has no derivative of its own); the backward is JAX's
    transpose of a dot with ``preferred_element_type``: f32 products of the
    f32 cotangent, rounded once to each operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return da, db


def _mm_f32(a, b):
    """f32 sums of 16-bit (M, K) @ (K, N) or (B, M, K) @ (B, K, N) on the
    card; through :class:`_MmF32` only when a gradient is wanted."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MmF32.apply(a, b)
    return (torch.mm if a.dim() == 2 else torch.bmm)(
        a, b, out_dtype=torch.float32)


def _mm(a, b):
    """``jnp.matmul(a, b, preferred_element_type=float32)``."""
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    if _f32_out(a, b) and a.dim() >= 2:
        if b.dim() == 2 or (b.dim() == 3 == a.dim() and b.shape[0] == 1):
            # b carries no batch: one (rows, K) @ (K, N) product
            out = _mm_f32(a.reshape(-1, a.shape[-1]), b.reshape(b.shape[-2:]))
            return out.reshape(*a.shape[:-1], b.shape[-1])
        if a.dim() == b.dim() == 3 and a.shape[0] == b.shape[0]:
            return _mm_f32(a, b)
    return torch.matmul(a.float(), b.float())


def _bmm(a, b):
    """``einsum("bij,bjk->bik", preferred_element_type=float32)``."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"bmm takes (B, I, J) @ (B, J, K), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    return _mm(a, b)


def _baddbmm(inp, a, b):
    return inp + _bmm(a, b).to(inp.dtype)


def _sdpa(query, key, value, bias=None, mask=None, *,
          scale: Optional[float] = None, is_causal: bool = False):
    """``jax.nn.dot_product_attention`` on (B, S, H, D) tensors (K / V may
    have fewer heads), through ``F.scaled_dot_product_attention``."""
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    attn = bias
    if mask is not None:
        m = mask if mask.dim() == 4 else mask[None, None]
        attn = (torch.where(m, 0.0, -math.inf) if bias is None else
                torch.where(m, bias, -math.inf)).to(q.dtype)
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn, is_causal=is_causal, scale=scale,
        enable_gqa=q.shape[1] != k.shape[1])
    return out.transpose(1, 2)


def _clip(x, min=None, max=None):  # noqa: A002 (jnp.clip's names)
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def _mean(x, axis=None, dtype=None, keepdims=False):
    if dtype is not None or not (x.dtype.is_floating_point or x.is_complex()):
        x = x.to(dtype or torch.float32)
    if axis is None:
        axis = tuple(range(x.dim()))
    return torch.mean(x, dim=axis, keepdim=keepdims)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _softmax(x):
    return F.softmax(x, dim=-1)


def _reshape(x, shape):
    return x.reshape(shape)


def _cat(xs, axis=0):
    return torch.cat(xs, axis)


register_operators(
    {
        "jnp.add": CallableOp(torch.add),
        "jnp.add_": UnaryOp(torch.add),  # in-place torch alias
        "jnp.mul": CallableOp(torch.mul),
        "jnp.clamp": CallableOp(_clip),
        "jnp.clamp_": UnaryOp(_clip),
        "jnp.matmul": CallableOp(_mm),
        "jnp.mm": CallableOp(_mm),
        "jnp.bmm": CallableOp(_bmm),
        "jnp.relu": CallableOp(F.relu),
        "jnp.gelu": CallableOp(_gelu),
        "jnp.softmax": CallableOp(_softmax),
        # fused scaled-dot-product attention (q, k, v: (B, S, H, D))
        "nn.sdpa": CallableOp(_sdpa),
        "jnp.reshape": CallableOp(_reshape),
        "nn.Linear": BuildableOp(_linear_ctor),
        "nn.Conv2d": BuildableOp(_conv2d_ctor),
        "jnp.baddbmm": CallableOp(_baddbmm),
        "jnp.cat": CallableOp(_cat),
        "jnp.mean": CallableOp(_mean),
        "nn.MaxPool2d": BuildableOp(_maxpool_ctor),
        "nn.AdaptiveAvgPool2d": BuildableOp(_adaptive_avgpool_ctor),
        "nn.Dropout": BuildableOp(_dropout_ctor),
        "nn.ReLU": BuildableOp(_relu_ctor),
        # reference-name aliases so torch-flavored configs load
        # (the reference's full native_basic_ops surface,
        # workloads/pytorch/native_basic_ops.py:8-37)
        "torch.add": CallableOp(torch.add),
        "torch.add_": UnaryOp(torch.add),
        "torch.clamp_": UnaryOp(_clip),
        "torch.baddbmm": CallableOp(_baddbmm),
        "torch.cat": CallableOp(_cat),
        "torch.mean": CallableOp(_mean),
        "torch.mul": CallableOp(torch.mul),
        "torch.reshape": CallableOp(_reshape),
        "torch.matmul": CallableOp(_mm),
        "torch.mm": CallableOp(_mm),
        "torch.bmm": CallableOp(_bmm),
        "torch.nn.functional.relu": CallableOp(F.relu),
        "torch.nn.Linear": BuildableOp(_linear_ctor),
        "torch.nn.Conv2d": BuildableOp(_conv2d_ctor),
        "torch.nn.MaxPool2d": BuildableOp(_maxpool_ctor),
        "torch.nn.AdaptiveAvgPool2d": BuildableOp(_adaptive_avgpool_ctor),
        "torch.nn.Dropout": BuildableOp(_dropout_ctor),
        "torch.nn.ReLU": BuildableOp(_relu_ctor),
    }
)
