"""Quantized communication: cast or quantize, communicate, dequantize (the
port's ``param_tpu/comms/quantization.py``; PARAM's quantized all-reduce
hooks and ``checkQuantArgs``).

- bitwidth 16: the collective runs in bfloat16 (NCCL or gloo sums bf16).
- bitwidth 8: int8 with one max-abs scale for the whole tensor, and one
  scale for each reduced chunk in the second phase.  An int8 sum would
  overflow, so :func:`quantized_all_reduce` runs the two-phase algorithm:
  an int8 all-to-all of the chunks with their scales gathered, an f32 sum
  of the dequantized chunks in rank order, then the requantized chunks
  all-gathered with their scales.
- non-reducing collectives (all_to_all, all_gather, reduce_scatter's
  payload) move the cast payload itself (:func:`quantized_cast_collective`).

Every function works on this rank's tensor and a :class:`CommGroup`; the
quantize and dequantize arithmetic runs under
``torch.profiler.record_function("quantize")`` / ``("dequantize")`` so a
profile can split device time into comm, quant and dequant
(``trace.device_trace.quant_comm_split``).  It is plain PyTorch, as the
reference's is plain XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

SUPPORTED_BITWIDTHS = (32, 16, 8)
# the collectives PARAM quantizes (checkQuantArgs)
QUANTIZABLE = {"all_reduce", "reduce", "all_to_all", "all_to_all_single",
               "all_gather", "reduce_scatter"}


def check_quant_args(collective: str, bitwidth: int) -> None:
    if bitwidth not in SUPPORTED_BITWIDTHS:
        raise ValueError(f"bitwidth must be one of {SUPPORTED_BITWIDTHS}")
    if bitwidth != 32 and collective not in QUANTIZABLE:
        raise ValueError(
            f"quantization unsupported for {collective!r}; "
            f"supported: {sorted(QUANTIZABLE)}")


def quantize(x: torch.Tensor, bitwidth: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (quantized values, f32 scale of the whole tensor, 0-d).  At 8
    bits ``scale = absmax / 127`` (1 for an all-zero tensor) and the values
    are ``round(x / scale)`` (half to even) clipped to +-127, in f32."""
    with record_function("quantize"):
        one = torch.ones((), dtype=torch.float32, device=x.device)
        if bitwidth == 32:
            return x, one
        if bitwidth == 16:
            return x.to(torch.bfloat16), one
        if bitwidth == 8:
            xf = x.float()
            absmax = xf.abs().max()
            scale = torch.where(absmax > 0, absmax / 127.0, one)
            q = torch.clamp(torch.round(xf / scale), -127, 127)
            return q.to(torch.int8), scale
    raise ValueError(f"unsupported bitwidth {bitwidth}")


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    with record_function("dequantize"):
        return (q.float() * scale).to(dtype)


def _gather_scale(scale: torch.Tensor, group) -> torch.Tensor:
    """The group's scales, in rank order: (n,) f32."""
    out = torch.empty(group.size, dtype=torch.float32, device=scale.device)
    dist.all_gather_into_tensor(out, scale.reshape(1), group=group.pg)
    return out


def quantized_all_reduce(x: torch.Tensor, group, bitwidth: int
                         ) -> torch.Tensor:
    """Quantized sum all-reduce of this rank's ``x`` over ``group`` (a
    :class:`CommGroup`); returns a new tensor, ``x`` is left as it was.

    bitwidth 16: the sum in bf16.  bitwidth 8: dim 0 padded to a multiple
    of n; phase 1 an int8 all-to-all (rank r receives chunk r of every
    rank) and the scales gathered, the chunks dequantized and summed in f32
    in rank order; phase 2 the reduced chunk requantized, the int8 chunks
    and their scales all-gathered, dequantized, the padding trimmed."""
    if bitwidth == 32:
        out = x.clone()
        dist.all_reduce(out, group=group.pg)
        return out
    if bitwidth == 16:
        out = x.to(torch.bfloat16, copy=True)
        dist.all_reduce(out, group=group.pg)
        return out.to(x.dtype)
    n = group.size
    orig = x.shape[0]
    rem = (-orig) % n
    if rem:
        x = torch.cat([x, x.new_zeros((rem, *x.shape[1:]))])
    chunk = x.shape[0] // n
    bcast = (n, *([1] * x.dim()))
    # phase 1: my chunk from every rank (a reduce-scatter in int8)
    q, scale = quantize(x, 8)
    mixed = torch.empty_like(q)
    dist.all_to_all_single(mixed, q.contiguous(), group=group.pg)
    scales = _gather_scale(scale, group)
    with record_function("dequantize"):
        parts = mixed.reshape(n, chunk, *x.shape[1:]).float() \
            * scales.reshape(bcast)
        reduced = parts[0]
        for r in range(1, n):
            reduced = reduced + parts[r]
    # phase 2: every rank's requantized reduced chunk
    q2, scale2 = quantize(reduced, 8)
    gathered = torch.empty((n * chunk, *x.shape[1:]), dtype=torch.int8,
                           device=x.device)
    dist.all_gather_into_tensor(gathered, q2.contiguous(), group=group.pg)
    scales2 = _gather_scale(scale2, group)
    out = dequantize(gathered.reshape(n, chunk, *x.shape[1:]),
                     scales2.reshape(bcast), x.dtype)
    return out.reshape(x.shape)[:orig]


def quantized_ring_reduce(x: torch.Tensor, group, bitwidth: int,
                          root: int) -> torch.Tensor:
    """Quantized rooted sum-reduce: a chain of n - 1 single-edge hops root
    + 1 -> root + 2 -> ... -> root (group ranks).  Each hop carries the
    quantized running partial (and its scale at 8 bits) from one rank to
    the next with a ``send`` / ``recv``; the receiver dequantizes it and
    adds its own f32 input.  The root returns the sum, the other ranks
    zeros."""
    n = group.size
    me = group.rank_of(dist.get_rank())
    acc = x.float()
    wire = torch.bfloat16 if bitwidth == 16 else torch.int8
    for k in range(1, n):
        src, dst = (root + k) % n, (root + k + 1) % n
        if me == src:
            q, scale = quantize(acc, bitwidth)
            dist.send(q.contiguous(), group.ranks[dst], group=group.pg)
            if bitwidth == 8:
                dist.send(scale.reshape(1), group.ranks[dst], group=group.pg)
        elif me == dst:
            q = torch.empty(acc.shape, dtype=wire, device=x.device)
            dist.recv(q, group.ranks[src], group=group.pg)
            if bitwidth == 8:
                scale = torch.empty(1, dtype=torch.float32, device=x.device)
                dist.recv(scale, group.ranks[src], group=group.pg)
                got = dequantize(q, scale.reshape(()))
            else:
                got = q.float()
            acc = got + x.float()
    out = acc if me == root else torch.zeros_like(acc)
    return out.to(x.dtype)


def quantized_cast_collective(x: torch.Tensor, bitwidth: int):
    """Pre-comm cast for non-reducing collectives; returns (payload,
    scale)."""
    return quantize(x, bitwidth)
