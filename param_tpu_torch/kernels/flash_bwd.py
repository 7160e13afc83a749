"""K7: flash-attention backward (``csrc/flash_bwd.cu``) and its plain
PyTorch version.

From the forward's inputs ``q`` (B, H, S_q, D), ``k`` and ``v`` (B, H_kv,
S_k, D), its output ``o`` (B, H, S_q, D), its f32 logsumexp ``lse`` (B, H,
S_q) (K6's, :func:`~param_tpu_torch.kernels.flash_fwd.flash_fwd` with
``return_lse``) and the output's gradient ``do``, compute (dq, dk, dv)
with P recomputed from the lse::

    P = exp(scale q k^T + mask - lse),  D = rowsum(do * o)
    dS = P (do v^T - D) scale
    dq = dS k,  dk = dS^T q,  dv = P^T do

GQA (H a multiple of H_kv): dk and dv sum over each kv head's query group.
``causal`` aligns the diagonal bottom-right (needs S_q <= S_k), as K6.
Counterpart of ``param_tpu/ops/attention.py::_bwd_dq_kernel_rect`` /
``_walk`` and ``::_bwd_dkv_kernel_rect`` / ``_walk``
(``flash_attention_bwd``); unlike that one it takes GQA.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from param_tpu_torch.kernels import bindings
from param_tpu_torch.kernels.flash_fwd import (
    HEAD_DIMS, PATHS, _MAX_ROWS, _check_args as _check_fwd_args, _path,
    _strides, attention_keep_mask, count_launch, kernel_takes,
)


def _check_args(q, k, v, o, lse, do, causal) -> None:
    _check_fwd_args(q, k, v, causal, None)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)}, "
                         f"got {tuple(o.shape)}, {tuple(do.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be (B, H, S_q) = {tuple(q.shape[:3])}, "
                         f"got {tuple(lse.shape)}")


def _plain_parts(q, k, v, o, lse, do, causal, scale):
    """f32 P, dP, D and scale, and the upcast operands (k repeated over
    each query group); dS = P (dP - D) scale."""
    _check_args(q, k, v, o, lse, do, causal)
    h, hkv = q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=1)
        vf = vf.repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.float()[..., None])
    keep = attention_keep_mask(q.shape[2], k.shape[2], causal, None, q.device)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    return p, dp, delta, scale, qf, kf, dof


def _group_sum(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, H, S, D) -> (B, H_kv, S, D), summing each kv head's group."""
    b, h, s, d = t.shape
    return t if h == hkv else t.reshape(b, hkv, h // hkv, s, d).sum(2)


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None):
    """Plain PyTorch version: straight-line f32 on upcast inputs, GQA
    through ``repeat_interleave`` and a sum of dk / dv over the group;
    outputs in the inputs' dtypes."""
    p, dp, delta, scale, qf, kf, dof = _plain_parts(q, k, v, o, lse, do,
                                                    causal, scale)
    hkv = k.shape[1]
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), qf), hkv)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), dof), hkv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_tolerance(q, k, v, o, lse, do, want, causal: bool = False,
                        scale: Optional[float] = None):
    """Per-element f32 bounds (on dq, dk, dv) on |K7 - ``want``|, ``want``
    being :func:`flash_bwd_plain` on the same inputs.

    With |P| and |dS| (dS scaled) from the plain version, the magnitudes
    m_dv = |P|^T |do|, m_dq = |dS| |k|, m_dk = |dS|^T |q|; in f32, where
    no rounding to the input dtype covers it, |dS| is taken as
    P (|dP| + |D|) scale, the size of the f32 terms that cancel in dP - D
    (a causal first row has dS = 0 exactly).
    bf16 / f16, u the dtype's unit roundoff (2^-8, 2^-11): each side rounds
    the output once, at most 2u |X| together, and K7 rounds P (for dv) and
    dS (for dq, dk) to the input dtype before their products, at most u m;
    a 2^-6 margin covers second-order terms and 2^-16 the f32 sums.
    f32: 2^-14 (|X| + m) + 1e-6, some thirty times the error of f32 sums
    taken in another order and of exp2f against exp."""
    p, dp, delta, scale, qf, kf, dof = _plain_parts(q, k, v, o, lse, do,
                                                    causal, scale)
    hkv = k.shape[1]
    if q.dtype == torch.float32:
        ds = p * (dp.abs() + delta.abs()) * scale
    else:
        ds = (p * (dp - delta) * scale).abs()
    mags = (torch.matmul(ds, kf.abs()),
            _group_sum(torch.matmul(ds.transpose(-1, -2), qf.abs()), hkv),
            _group_sum(torch.matmul(p.transpose(-1, -2), dof.abs()), hkv))
    if q.dtype == torch.float32:
        return tuple(2.0 ** -14 * (w.float().abs() + m) + 1e-6
                     for w, m in zip(want, mags))
    u = 2.0 ** -8 if q.dtype == torch.bfloat16 else 2.0 ** -11
    return tuple((1 + 2.0 ** -6) * u * (2 * w.float().abs() + m) + 2.0 ** -16
                 for w, m in zip(want, mags))


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where K7 takes its strides (e.g. the transposed-head
    gradient of the block's attention output), else a contiguous copy (e.g.
    the expanded gradient of a sum)."""
    return t if kernel_takes(t) else t.contiguous()


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None):
    """Launch K7 on ``q``'s CUDA device, on the path
    :func:`~param_tpu_torch.kernels.flash_fwd.flash_schedule` picks: the dq
    kernel (which also writes D = rowsum(do * o) to a scratch buffer), then
    the dk/dv kernel.  q, k, v, o and do may be strided views whose last
    dimension is contiguous; dq, dk and dv come out contiguous in the
    inputs' dtype."""
    _check_args(q, k, v, o, lse, do, causal)
    (b, h, sq, d), (_, hkv, sk, _) = q.shape, k.shape
    ins = (q, k, v, o, do)
    if d not in HEAD_DIMS:
        raise ValueError(f"K7 takes head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in bindings.DTYPE_CODES or \
            any(t.dtype != q.dtype for t in ins):
        raise TypeError(f"K7 takes f32, bf16 or f16 q, k, v, o and do of "
                        f"one dtype, got {[t.dtype for t in ins]}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("K7 takes a contiguous f32 lse")
    if any(t.device != q.device for t in ins + (lse,)):
        raise ValueError("K7's inputs must share a device")
    path = _path(ins)
    if b * max(h, hkv) > _MAX_ROWS or max(sq, sk) >= 2**31:
        raise ValueError("attention dimensions out of the kernel's range")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if not (dq.numel() and dk.numel()):  # no (row, column) pair at all
        for t in (dq, dk, dv):
            t.zero_()
    else:
        # wgmma: lse log2(e) and D, each (B H, S_q rounded up to 128)
        shape = ((2, b * h, -(-sq // 128) * 128) if path == "wgmma"
                 else (b, h, sq))
        delta = torch.empty(shape, dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 15)(*[s for t in ins
                                              for s in _strides(t)])
        rc = bindings.entry("flash_bwd", "flash_bwd_launch")(
            PATHS[path], bindings.DTYPE_CODES[q.dtype], d,
            *(t.data_ptr() for t in ins), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, sk,
            strides, float(scale), int(causal), bindings.stream_of(q))
        bindings.check(rc, f"flash_bwd ({path})")
        count_launch("flash_bwd", path)
    return dq, dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None):
    """K7 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
    raise ValueError(f"unsupported device {q.device}")
