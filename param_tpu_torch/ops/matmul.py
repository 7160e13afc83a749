"""GEMM: ``torch.matmul`` and the hand-written kernels K3, K4 and K5 (port
of ``param_tpu/ops/matmul.py``).

- :func:`matmul`: ``torch.matmul`` with f32 accumulation, the counterpart
  of the reference's XLA dot.
- :func:`matmul_pallas`: K3, the tiled GEMM.  The name and the ``block_*``
  keywords stay so that the same calls succeed or fail in both packages;
  K3's own tiles do not depend on them and it masks ragged edges.
- :func:`matmul_weight_resident`: K4, S GEMMs against one shared B.
- :func:`pack_int4` and :func:`matmul_int4`: group-wise int4 weights and
  K5, ``x @ W`` unpacking the nibbles in registers.

Every function runs its kernel on CUDA tensors and the kernel's plain
version on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from param_tpu_torch.kernels.gemm import gemm, gemm_wres
from param_tpu_torch.kernels.int4_gemm import int4_gemm

INT4_VARIANTS = ("tile-scale", "float-unpack", "group-dots")


def gemm_flops(m: int, n: int, k: int) -> int:
    """2*M*N*K."""
    return 2 * m * n * k


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` with f32 accumulation, in ``out_dtype`` (default ``a``'s).
    An f32 output of bf16/f16 operands keeps the f32 sums (cuBLAS writes
    them directly on the card), as the reference's
    ``preferred_element_type=float32`` dot does."""
    out_dtype = out_dtype or a.dtype
    if out_dtype == a.dtype:
        return torch.matmul(a, b)
    if a.device.type == "cuda" and out_dtype == torch.float32 and \
            a.dim() == b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_pallas(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 2048,
                  block_n: int = 512, block_k: int = 512,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K3: tiled GEMM with an f32 accumulator, output in ``out_dtype``
    (default ``a``'s).  Raises ``ValueError`` when the shape does not divide
    the blocks (each clipped to its dimension), as the reference does."""
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    block_m, block_n, block_k = min(block_m, m), min(block_n, n), \
        min(block_k, k)
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(f"shapes ({m},{n},{k}) must divide blocks "
                         f"({block_m},{block_n},{block_k})")
    return gemm(a, b, out_dtype)


def matmul_weight_resident(a_stack: torch.Tensor, b: torch.Tensor, *,
                           block_n: int = 512,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """K4: S small-M GEMMs (S, M, K) @ (K, N) -> (S, M, N) against one
    shared B, read from device memory once.  ``block_n`` (clipped to N) must
    divide N, as in the reference."""
    (_, _, k), (k2, n) = a_stack.shape, b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a_stack.shape)} @ "
                         f"{tuple(b.shape)}")
    if n % min(block_n, n):
        raise ValueError(f"block_n={block_n} must divide N={n}")
    return gemm_wres(a_stack, b, out_dtype)


def pack_int4(w: torch.Tensor, group: int = 128):
    """Quantize (K, N) float weights to group-wise int4: two nibbles per
    int8 byte along K (even K-rows in the low nibble, stored +8-biased; odd
    in the high), per-(group, output-column) max-abs / 7 scales.

    Returns (packed (K//2, N) int8, scale (K//group, N) f32), byte for byte
    what the reference's ``pack_int4`` returns."""
    k, n = w.shape
    g = min(group, k)
    if k % g or g % 2:
        raise ValueError(f"K={k} must be a multiple of an even group ({g})")
    wf = w.float().reshape(k // g, g, n)
    absmax = wf.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7)
    return pack_nibbles(q.to(torch.int8).reshape(k, n)), scale


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 values in [-8, 7] -> (K//2, N) bytes in the
    :func:`pack_int4` layout: ``(q[0::2] + 8) | (q[1::2] << 4)``."""
    return torch.bitwise_or(q[0::2] + 8, torch.bitwise_left_shift(q[1::2], 4))


def matmul_int4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                block_n: int = 0, block_k: int = 1024,
                out_dtype: Optional[torch.dtype] = None,
                variant: str = "tile-scale") -> torch.Tensor:
    """K5: ``x`` (M, K) @ int4 weights ((K//2, N) int8 + (K//g, N) f32
    scales, the :func:`pack_int4` layout) -> (M, N) in ``out_dtype``
    (default ``x``'s).  ``x`` is rounded to bf16 first, as in the reference;
    each weight is dequantized in f32.

    ``variant`` names one of the reference's three TPU schedules of this one
    function; the port has one kernel, so all three run it.  ``block_k`` is
    accepted and unused: the kernel masks K itself, with no padding.  Any N
    works with ``block_n=0``; an explicit ``block_n`` must divide N."""
    if variant not in INT4_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {INT4_VARIANTS}")
    (m, k), (kh, n) = x.shape, packed.shape
    if k != 2 * kh or scale.shape[0] == 0 or kh % scale.shape[0]:
        raise ValueError(f"inconsistent int4 shapes: x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if block_n and n % block_n:
        raise ValueError((n, block_n))
    xb = x.to(torch.bfloat16).contiguous()
    return int4_gemm(xb, packed.contiguous(), scale.float().contiguous(),
                     out_dtype or x.dtype)
