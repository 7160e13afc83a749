"""Multi-head attention: the unfused reference and the flash kernels, K6
forward and K7 backward (port of ``param_tpu/ops/attention.py``).

- :func:`mha_reference`: straight-line attention, the parity oracle and
  the unfused path (``xla`` in the benches): f32 scores from upcast
  inputs, P cast to q's dtype before the PV product, as in the reference.
- :func:`flash_attention`: K6 on the card, its plain version on the CPU.
  The reference's checks stay (blocks must divide the sequences, heads
  must divide by kv heads, causal needs S_q <= S_k, a window needs
  causal); ``block_q`` / ``block_k`` are only validated, since K6 picks
  its own tiles.
- :func:`flash_attention_bwd`: K7 on the card, its plain version on the
  CPU: (dq, dk, dv) from the forward's (o, lse) and the output gradient.
- :func:`flash_mha`: the training path's dispatch, an autograd function
  with K6 forward and K7 backward.
- :func:`decode_attention`: one query token against a KV cache (the
  decode step's attention, plain PyTorch as the reference's is plain XLA).
- :func:`make_attention`: the bench's path table (``xla``, ``flash``,
  ``dpa``).

Layouts are the reference's: q (B, H, S_q, D), k and v (B, H_kv, S_k, D).
The TPU-only layouts (head packing for D < 128, the 128-lane lse) are not
ported: the lse is (B, H, S_q) f32.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from param_tpu_torch.kernels.flash_bwd import flash_bwd, kernel_layout
from param_tpu_torch.kernels.flash_fwd import attention_keep_mask, flash_fwd

_NEG_INF = -1e30


def attention_flops(b: int, h: int, sq: int, sk: int, d: int,
                    causal: bool = False) -> int:
    """Matmul flops of one attention forward: QK^T and PV, 2*S_q*S_k*D
    each, less the area above the bottom-right-aligned diagonal when
    causal (``(S_k - S_q/2) / S_k`` of the rectangle for S_q <= S_k)."""
    full = 2 * (2 * b * h * sq * sk * d)
    if not causal:
        return full
    if sq <= sk:
        return int(full * (sk - sq / 2) / sk)
    return full // 2


def attention_bytes(b: int, h: int, sq: int, sk: int, d: int,
                    itemsize: int) -> int:
    """Least device-memory traffic of a fused attention: read Q, K, V,
    write O (K and V counted per query head, as in the reference)."""
    return itemsize * b * h * (2 * sq * d + 2 * sk * d)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Unfused attention over (B, H, S, D), the parity oracle.  GQA (fewer
    kv heads) repeats each kv head over its query group; the window
    applies only with ``causal``, as in the reference."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] != q.shape[1]:
        group = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = attention_keep_mask(s.shape[-2], s.shape[-1], causal,
                               window if causal else None, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention forward over (B, H, S, D) with f32 accumulation:
    K6 on CUDA tensors, its plain version on CPU tensors."""
    return _flash_forward(q, k, v, causal=causal, scale=scale,
                          block_q=block_q, block_k=block_k,
                          return_lse=False, window=window)


def _check_blocks(sq, sk, block_q, block_k) -> None:
    """The reference's guard: its Pallas grid needs blocks that divide the
    sequences (the port's kernels pick their own tiles)."""
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq ({sq},{sk}) must divide blocks "
                         f"({block_q},{block_k})")


def _flash_forward(q, k, v, *, causal, scale, block_q, block_k, return_lse,
                   window=None):
    """Forward body; with ``return_lse`` also the (B, H, S_q) f32
    logsumexp of each row (the residual K7 takes)."""
    h, sq = q.shape[1], q.shape[2]
    h_kv, sk = k.shape[1], k.shape[2]
    _check_blocks(sq, sk, block_q, block_k)
    if h % h_kv:
        raise ValueError(f"q heads {h} must divide by kv heads {h_kv}")
    if causal and sk < sq:
        raise NotImplementedError(
            "causal flash attention requires S_q <= S_k (decode layout); "
            "got S_q > S_k")
    if window is not None:
        if not causal:
            raise NotImplementedError("sliding window requires causal")
        if return_lse:
            raise NotImplementedError(
                "sliding window is forward/serving-tier only")
    return flash_fwd(q, k, v, causal, scale, window, return_lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = False, scale: Optional[float] = None,
                        block_q: int = 1024, block_k: int = 1024):
    """Flash attention backward: (dq, dk, dv) from the saved (o, lse) and
    the output gradient ``do``; K7 on CUDA tensors, its plain version on
    CPU tensors.  ``lse`` is the port's (B, H, S_q) f32; ``block_q`` /
    ``block_k`` are only validated, as in :func:`flash_attention`.  GQA (k
    and v with fewer heads than q) is taken, with dk and dv summed over
    each kv head's query group."""
    _check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    return flash_bwd(q, k, v, o, lse, do, causal, scale)


def _flash_mha_supported(q, k, causal) -> bool:
    sq, sk = q.shape[2], k.shape[2]
    bq, bk = min(1024, sq), min(1024, sk)
    return sq % bq == 0 and sk % bk == 0 and not (causal and sq > sk)


class _FlashMHA(torch.autograd.Function):
    """K6 forward with the lse, K7 backward; the residuals are (q, k, v, o,
    lse), O(S D) as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale, None, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, kernel_layout(do), ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None):
    """Training-path attention, flash in both directions: K6 forward and K7
    backward on CUDA tensors at every shape K6 takes (ragged sequences and
    GQA included; causal S_q > S_k, which no kernel of either package
    takes, raises).  On CPU tensors the shapes the reference's Pallas grid
    cannot tile (S not a multiple of its 1024 block, causal S_q > S_k) fall
    back to :func:`mha_reference` in both directions, as the reference
    does, and the others run the kernels' plain versions.  Without a
    gradient to take (no input requires one, or grad mode is off) the
    forward computes no lse."""
    if q.device.type == "cpu" and not _flash_mha_supported(q, k, causal):
        return mha_reference(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashMHA.apply(q, k, v, causal, scale)
    return flash_fwd(q, k, v, causal, scale)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with an f32 result, the operands read in their own
    dtype (cuBLAS accumulates in f32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query token per head against a KV cache: q (B, H_kv, G, D)
    (G query heads per kv head), k / v (B, H_kv, S, D), ``valid`` an
    optional (S,) bool mask of the cache positions to attend.  f32 logits
    and output, P in q's dtype, each kv head read once for its group.

    On the card the cache is contracted in its stored dtype with f32
    accumulation, as the reference's ``preferred_element_type`` einsums do
    (no f32 copy of the cache); on the CPU, which has no such product, the
    operands are upcast (bf16 products are exact in f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, hk, g, d = q.shape
    s = k.shape[2]
    on_card = q.device.type == "cuda" and q.dtype == k.dtype == v.dtype
    if on_card:
        kt = k.reshape(b * hk, s, d).transpose(1, 2)  # a view of the cache
        logits = _bmm_f32(q.reshape(b * hk, g, d), kt).view(b, hk, g, s)
    else:
        logits = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float())
    logits = logits * scale
    if valid is not None:
        logits = logits.masked_fill(~valid, _NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    if on_card:
        dv = v.shape[-1]
        return _bmm_f32(p.reshape(b * hk, g, s),
                        v.reshape(b * hk, s, dv)).view(b, hk, g, dv)
    return torch.einsum("bkgs,bksd->bkgd", p.float(), v.float())


def make_attention(path: str, *, causal: bool = False):
    """Dispatch table for the bench tier: 'xla' (the unfused reference),
    'flash' (K6), 'dpa' (``F.scaled_dot_product_attention``, the library
    A/B row; its ``is_causal`` aligns the diagonal top-left, which equals
    the reference's for S_q == S_k, the bench's shapes)."""
    if path == "xla":
        return functools.partial(mha_reference, causal=causal)
    if path == "flash":
        return functools.partial(flash_attention, causal=causal)
    if path == "dpa":
        def _run(q, k, v):
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=k.shape[1] != q.shape[1])
        return _run
    if path == "jax-flash":
        raise ValueError("'jax-flash' is JAX's bundled TPU kernel and has no "
                         "counterpart in the port")
    raise ValueError(f"unknown attention path: {path}")
