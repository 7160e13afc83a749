"""K6: flash-attention forward (``csrc/flash_fwd.cu``) and its plain
PyTorch version.

``q`` (B, H, S_q, D), ``k`` and ``v`` (B, H_kv, S_k, D) with H a multiple
of H_kv (GQA: query head h reads kv head h // (H / H_kv)).  Returns O
(B, H, S_q, D) in q's dtype and, with ``return_lse``, the f32 logsumexp of
each row's scaled, masked scores, (B, H, S_q).  ``causal`` aligns the
diagonal bottom-right (row r keeps columns c <= r + S_k - S_q; needs
S_q <= S_k); ``window`` W (causal only) also drops c <= r + S_k - S_q - W.
Counterpart of ``param_tpu/ops/attention.py::_flash_kernel`` and
``::_flash_kernel_causal`` (``_flash_forward``).

K6 and K7 (:mod:`.flash_bwd`) have three hand-written paths, picked before
the launch by :func:`flash_schedule`: ``wgmma`` (TMA loads into mbarrier
rings, a producer warp and two consumer warpgroups on ``wgmma``) for bf16
/ f16 at D 64 and 128 when every view is one a TMA tensor map can describe
(:func:`tma_takes`); ``mma_sync`` for the other 16-bit shapes (D = 32);
``tf32x3`` for f32: every product on the tensor cores as three TF32
products of the operands split into two TF32 halves (``csrc/tf32x3.cuh``),
as accurate as f32; it reads any view :func:`kernel_takes`, with 16-byte
copies where every base and stride is 16-byte aligned and 4-byte ones
otherwise.  Launch counters: ``flash_fwd`` / ``flash_bwd`` per call and
``flash_fwd_<path>`` / ``flash_bwd_<path>`` for the path taken.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from param_tpu_torch.kernels import bindings, launch_counts

HEAD_DIMS = (32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
# path -> its code in csrc/flash_fwd.cu and csrc/flash_bwd.cu
PATHS = {"tf32x3": 0, "mma_sync": 1, "wgmma": 2}
_MAX_ROWS = 65535  # B * H: the grid's y dimension


def _check_args(q, k, v, causal, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, H, S_q, D), k and v (B, H_kv, S_k, D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    (b, h, sq, d), (bk, hkv, sk, dk) = q.shape, k.shape
    if bk != b or dk != d or hkv == 0 or h % hkv:
        raise ValueError(f"inconsistent attention shapes: q {tuple(q.shape)},"
                         f" k/v {tuple(k.shape)}")
    if causal and sq > sk:
        raise NotImplementedError("causal attention needs S_q <= S_k")
    if window is not None and (not causal or window < 1):
        raise NotImplementedError("a sliding window needs causal and W >= 1")


def attention_keep_mask(sq: int, sk: int, causal: bool,
                        window: Optional[int], device) -> Optional[torch.Tensor]:
    """(S_q, S_k) bool: the columns each row attends (None: all)."""
    if not causal:
        return None
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    keep = ki <= qi + (sk - sq)
    if window is not None:
        keep = keep & (ki > qi + (sk - sq) - window)
    return keep


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    window: Optional[int] = None, return_lse: bool = False):
    """Plain PyTorch version: straight-line f32 attention on upcast inputs,
    masked scores -1e30 as in the TPU kernel, O cast to q's dtype."""
    _check_args(q, k, v, causal, window)
    h, hkv = q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    if hkv != h:
        kf = kf.repeat_interleave(h // hkv, dim=1)
        vf = vf.repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    keep = attention_keep_mask(q.shape[2], k.shape[2], causal, window,
                               q.device)
    if keep is not None:
        s = s.masked_fill(~keep, -1e30)
    out = torch.matmul(torch.softmax(s, dim=-1), vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_fwd_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        want: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Per-element f32 bound on |K6 - ``want``|, ``want`` being
    :func:`flash_fwd_plain` on the same inputs.

    f32: 2e-5, the reference's flash tolerance.  bf16 / f16, with u the
    dtype's unit roundoff (2^-8, 2^-11): each side rounds O once, at most
    2u |O| together, and K6 rounds P to the input dtype before the PV
    product, at most u (|P| @ |V|) (the plain version on |v|).  A 2^-6
    margin covers second-order terms and 2^-16 the f32 sums."""
    if q.dtype == torch.float32:
        return torch.full(want.shape, 2e-5, device=want.device)
    u = 2.0 ** -8 if q.dtype == torch.bfloat16 else 2.0 ** -11
    pv = flash_fwd_plain(q, k, v.abs(), causal, scale, window).float()
    return (1 + 2.0 ** -6) * u * (2 * want.float().abs() + pv) + 2.0 ** -16


def _strides(t: torch.Tensor):
    return [int(x) for x in t.stride()[:3]]


def kernel_takes(t: torch.Tensor) -> bool:
    """Whether K6 / K7 read the (B, H, S, D) ``t`` through its strides:
    last dimension contiguous and, for bf16 / f16 (16-byte copies of rows),
    the base 16-byte aligned and every stride a multiple of 8 elements."""
    sb, sh, ss, sd = t.stride()
    if sd != 1:
        return False
    return t.dtype == torch.float32 or (
        t.data_ptr() % 16 == 0 and not (sb % 8 or sh % 8 or ss % 8))


def tma_takes(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map (csrc/hopper.cuh ``encode_bhsd``) describes
    the 16-bit (B, H, S, D) view ``t``: what :func:`kernel_takes` asks, and
    no zero stride (an expanded dimension)."""
    return (t.dtype != torch.float32 and kernel_takes(t)
            and 0 not in t.stride()[:3])


def _path(views) -> str:
    """The path of K6 / K7 for these views; raises for views no kernel
    reads (on the main path only :func:`tma_takes` runs)."""
    q = views[0]
    aligned = all(tma_takes(t) for t in views)
    if not aligned and not all(kernel_takes(t) for t in views):
        raise ValueError("K6 / K7 take tensors whose last dimension is "
                         "contiguous (bf16/f16: 16-byte aligned rows, "
                         "strides a multiple of 8 elements)")
    return flash_schedule(q.dtype, q.shape[-1], aligned)


def flash_schedule(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The path of K6 / K7 for inputs of ``dtype`` and head dim ``d``:
    ``tf32x3`` for f32 (whatever the alignment); ``wgmma`` for 16-bit
    inputs at D 64 or 128 when ``aligned`` (every view :func:`tma_takes`);
    else ``mma_sync``."""
    if dtype == torch.float32:
        return "tf32x3"
    if aligned and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma_sync"


def count_launch(kernel: str, path: str) -> None:
    """One launch of ``kernel`` (``flash_fwd`` / ``flash_bwd``) on ``path``."""
    launch_counts[kernel] += 1
    launch_counts[f"{kernel}_{path}"] += 1


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   window: Optional[int] = None, return_lse: bool = False):
    """Launch K6 on ``q``'s CUDA device.  q, k and v may be strided views
    (e.g. heads split out of a fused QKV projection) as long as their last
    dimension is contiguous."""
    _check_args(q, k, v, causal, window)
    (b, h, sq, d), (_, hkv, sk, _) = q.shape, k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"K6 takes head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in bindings.DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"K6 takes f32, bf16 or f16 q, k and v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share a device")
    path = _path((q, k, v))
    if b * h > _MAX_ROWS or max(sq, sk) >= 2**31:
        raise ValueError("attention dimensions out of the kernel's range")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        rc = bindings.entry("flash_fwd", "flash_fwd_launch")(
            PATHS[path], bindings.DTYPE_CODES[q.dtype], d, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, b, h, hkv, sq, sk,
            *_strides(q), *_strides(k), *_strides(v), float(scale),
            int(causal), int(window or 0), bindings.stream_of(q))
        bindings.check(rc, f"flash_fwd ({path})")
        count_launch("flash_fwd", path)
    return (out, lse) if return_lse else out


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None,
              window: Optional[int] = None, return_lse: bool = False):
    """K6 for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, scale, window, return_lse)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale, window, return_lse)
    raise ValueError(f"unsupported device {q.device}")
