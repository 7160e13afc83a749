"""K5: x @ group-int4 W (``csrc/int4_gemm.cu``) and its plain PyTorch
version.

``packed`` (K/2, N) int8 holds two weights per byte along K: row 2i in the
low nibble, stored +8-biased (``(b & 15) - 8``), row 2i+1 in the high
nibble (``b >> 4``, arithmetic); ``scale`` (K/g, N) f32 scales packed row i
by ``scale[i // (g/2)]``.  ``x`` (M, K) is bf16.  Each weight is
dequantized in f32 and the product accumulated in f32; the output is in
``out_dtype`` (default bf16).  Counterpart of
``param_tpu/ops/matmul.py::_mm_int4_kernel`` (``matmul_int4``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import torch

from param_tpu_torch.kernels import bindings, launch_counts

_MMA_ROWS, _MMA_COLS = 16, 512  # x rows and columns of one block


def int4_dequant(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The (K, N) f32 weights of a packed int4 matrix."""
    kh, n = packed.shape
    p = packed.to(torch.int32)
    s = scale.float().repeat_interleave(kh // scale.shape[0], dim=0)
    w = torch.empty((2 * kh, n), dtype=torch.float32, device=packed.device)
    w[0::2] = ((p & 15) - 8).float() * s
    w[1::2] = (p >> 4).float() * s
    return w


def int4_gemm_plain(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: f32 dequantized weights, f32 product."""
    out = torch.matmul(x.float(), int4_dequant(packed, scale))
    return out.to(out_dtype or x.dtype)


@lru_cache(maxsize=None)
def mma_schedule(m: int, n: int, kh: int, sms: int):
    """(packed rows per K split, K splits) of the tensor-core path: about
    four blocks per SM, splits a multiple of 8 rows (one k16 step)."""
    tiles = math.ceil(m / _MMA_ROWS) * math.ceil(n / _MMA_COLS)
    splits = max(1, math.ceil(4 * sms / tiles))
    rows = max(8, math.ceil(kh / splits / 8) * 8)
    return rows, math.ceil(kh / rows)


def int4_gemm_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch K5 on ``x``'s CUDA device."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError("x (M, K), packed (K/2, N) and scale (K/g, N) "
                         "expected")
    (m, k), (kh, n) = x.shape, packed.shape
    groups = scale.shape[0]
    if k != 2 * kh or scale.shape[1] != n or groups == 0 or kh % groups:
        raise ValueError(f"inconsistent int4 shapes: x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if x.dtype != torch.bfloat16 or packed.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise TypeError("K5 takes bf16 x, int8 packed and f32 scale, got "
                        f"{x.dtype}, {packed.dtype}, {scale.dtype}")
    if out_dtype not in bindings.DTYPE_CODES:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    for t in (packed, scale):
        if t.device != x.device:
            raise ValueError("x, packed and scale must share a device")
    if not all(t.is_contiguous() for t in (x, packed, scale)):
        raise ValueError("K5 takes contiguous tensors")
    if max(m * k, kh * n, m * n) >= 2**31 or m >= 65535 * 128:
        raise ValueError("int4 GEMM dimensions out of the kernel's range")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    gh, code = kh // groups, bindings.DTYPE_CODES[out_dtype]
    stream = bindings.stream_of(x)
    if gh % 8 == 0:  # the tensor-core path: whole k16 steps per group
        if x.data_ptr() % 4:
            raise ValueError("K5 takes x 4-byte aligned")
        rows, splits = mma_schedule(m, n, kh,
                                    bindings.sm_count(x.device.index))
        partial = torch.empty((splits, m, n), dtype=torch.float32,
                              device=x.device)
        vec = n % 16 == 0 and packed.data_ptr() % 16 == 0
        rc = bindings.entry("int4_gemm", "int4_gemm_mma")(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            partial.data_ptr(), out.data_ptr(), code, m, n, kh, gh, rows,
            splits, int(vec), stream)
    else:
        rc = bindings.entry("int4_gemm", "int4_gemm_tiled")(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            code, m, n, kh, gh, stream)
    bindings.check(rc, "int4_gemm")
    launch_counts["int4_gemm"] += 1
    return out


def int4_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K5 for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return int4_gemm_cuda(x, packed, scale, out_dtype)
    if x.device.type == "cpu":
        return int4_gemm_plain(x, packed, scale, out_dtype)
    raise ValueError(f"unsupported device {x.device}")
