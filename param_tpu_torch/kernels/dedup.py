"""The dedup's segment sum (``csrc/dedup.cu``) and its plain PyTorch version.

A DLRM sparse step's lookups, ``ids`` (M, nnz) row ids in the flat view of
the tables, all carry their bag's row of the pooled gradient ``g`` (M, D).
:func:`dedup_sum` returns what :func:`~param_tpu_torch.ops.sparse_update.
dedup_row_updates` returns for one gradient row a lookup (``scale * g[m]``
for each id of bag m): ``rows`` (N,) int32, the distinct ids in ascending
order as a prefix and ``drop_marker`` in the tail, and ``totals`` (N, D)
f32, each id's rows summed, zero in the tail (N = M * nnz).

With ``bag_sizes`` (T per-feature sizes, L their sum; the layout of
:mod:`~param_tpu_torch.kernels.emb_gather`'s per-feature bags), ``ids`` is
(B, L), one row a sample, ``g`` (B * T, D), and lookup (b, j) carries bag
``b * T + t`` of its column's feature t: the ids are the B * L real ones,
with no pad slot.

On the card the per-lookup rows are never built: a stable sort of the ids,
the run numbers from a cumulative sum of run starts, then the kernel sums
rows of ``g`` in sorted order, chunk by chunk (:data:`CHUNK` sorted
positions a lane group), then adds the parts of runs that cross a chunk's
end up a tree of levels (:data:`GROUP` entries a lane group a level), so no
lane group's work grows with a run's length.  Static shapes and no host
synchronisation.  The CPU kernel is the plain version: the expansion, then
``dedup_row_updates``.

The op is ``torch.ops.param_tpu_torch.dedup_sum``, so a captured graph
holds one node for it.  While a profiler runs, it adds the number of runs
to the counter ``dlrm.unique_rows`` and the runs that cross a chunk's end
(the tree's work) to ``dlrm.dedup_carried_runs``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts
from param_tpu_torch.kernels.emb_gather import (
    bag_layout, check_bag_sizes, per_feature,
)
from param_tpu_torch.utils.profiler import count, recording

CHUNK = 32  # sorted positions a lane group of the kernel walks
GROUP = 32  # carries a lane group adds a level of the tree


def dedup_lanes(dim: int, vec: int) -> int:
    """Lanes a row: enough for ``dim`` in ``vec``-wide accesses, a power of
    two, at most a warp (wider rows take several passes of a chunk)."""
    return min(32, 1 << (-(-dim // vec) - 1).bit_length())


def carried_runs(sidx: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Runs of the sorted ids ``sidx`` that cross the end of a chunk of
    ``chunk`` positions, as a 0-d tensor (static shapes)."""
    edges = torch.arange(chunk, sidx.shape[0], chunk, device=sidx.device)
    cross = sidx[edges - 1] == sidx[edges]
    later = torch.zeros_like(cross)  # the run also crosses the next edge
    later[:-1] = sidx[edges[:-1]] == sidx[edges[1:]]
    return (cross & ~later).sum()


def _check_bags(ids: torch.Tensor, g: torch.Tensor,
                bag_sizes: Optional[Sequence[int]]) -> None:
    if ids.dim() != 2 or g.dim() != 2:
        raise ValueError("ids (M, nnz) and g (M, D) expected")
    bags = ids.shape[0] * (1 if bag_sizes is None else len(bag_sizes))
    if g.shape[0] != bags:
        raise ValueError(f"g must hold {bags} bags, got {g.shape[0]}")
    if bag_sizes is not None:
        check_bag_sizes(bag_sizes, ids.shape[1])


def dedup_sum_plain(ids: torch.Tensor, g: torch.Tensor,
                    scale: Optional[float], drop_marker: int,
                    bag_sizes: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: one gradient row a lookup, then
    ``dedup_row_updates``."""
    from param_tpu_torch.ops.sparse_update import dedup_row_updates

    _check_bags(ids, g, bag_sizes)
    flat = ids.reshape(-1)
    if bag_sizes is None:
        rows_g = g.repeat_interleave(ids.shape[1], dim=0)
    else:
        rows_g = per_feature(g, bag_sizes).reshape(-1, g.shape[1])
    if scale is not None:
        rows_g = scale * rows_g
    if flat.numel() and recording():
        count("dlrm.dedup_carried_runs",
              carried_runs(torch.sort(flat, stable=True).values))
    return dedup_row_updates(flat, rows_g, drop_marker)


def dedup_sum_cuda(ids: torch.Tensor, g: torch.Tensor,
                   scale: Optional[float], drop_marker: int,
                   bag_sizes: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort, the run numbers and the kernel's launches (the chunks,
    then the carries' levels) on ``g``'s CUDA device."""
    _check_bags(ids, g, bag_sizes)
    if ids.device != g.device:
        raise ValueError("ids and g must share a device")
    if not (ids.is_contiguous() and g.is_contiguous()):
        raise ValueError("the dedup takes contiguous tensors")
    if g.dtype != torch.float32:
        raise TypeError(f"the dedup takes an f32 gradient, got {g.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"the dedup takes int32 row ids, got {ids.dtype}")
    M, nnz = ids.shape
    D = g.shape[1]
    N = M * nnz
    if N > 2**30:
        raise ValueError("the dedup takes at most 2**30 lookups")
    dev = g.device
    rows = torch.empty((N,), dtype=torch.int32, device=dev)
    totals = torch.empty((N, D), dtype=torch.float32, device=dev)
    if N == 0:
        return rows, totals
    sidx, order = torch.sort(ids.reshape(-1), stable=True)
    # a fill, not `start[0] = True`: a host scalar's copy would wait for
    # the stream
    start = torch.ones((N,), dtype=torch.bool, device=dev)
    torch.ne(sidx[1:], sidx[:-1], out=start[1:])
    run_no = torch.cumsum(start, 0, dtype=torch.int32)
    chunks = -(-N // CHUNK)
    entries = chunks + -(-chunks // GROUP)  # a level's and the next's
    carry = torch.empty((entries, D), dtype=torch.float32, device=dev)
    key = torch.empty((entries,), dtype=torch.int32, device=dev)
    carried = (torch.zeros((), dtype=torch.int32, device=dev)
               if recording() else None)
    vec = bindings.vec_width(D, 4, g, totals, carry)
    feats = (None if bag_sizes is None
             else bag_layout(bag_sizes, dev)[1].data_ptr())
    fn = bindings.entry("dedup", "dedup_sum_f32")
    rc = fn(g.data_ptr(), order.data_ptr(), sidx.data_ptr(),
            run_no.data_ptr(), N, nnz, D, CHUNK, GROUP, vec,
            dedup_lanes(D, vec), 1.0 if scale is None else float(scale),
            drop_marker, rows.data_ptr(), totals.data_ptr(),
            carry.data_ptr(), key.data_ptr(),
            None if carried is None else carried.data_ptr(), feats,
            1 if bag_sizes is None else len(bag_sizes), bindings.stream_of(g))
    bindings.check(rc, "dedup_sum")
    launch_counts["dedup_sum"] += 1
    if carried is not None:
        count("dlrm.unique_rows", run_no[-1].long())
        count("dlrm.dedup_carried_runs", carried)
    return rows, totals


def _dedup_sum_meta(ids, g, scale, drop_marker, bag_sizes=None):
    N = ids.shape[0] * ids.shape[1]
    return (ids.new_empty((N,), dtype=torch.int32),
            g.new_empty((N, g.shape[1])))


_LIB = torch.library.Library("param_tpu_torch", "FRAGMENT")
_LIB.define("dedup_sum(Tensor ids, Tensor g, float? scale, int drop_marker, "
            "int[]? bag_sizes=None) -> (Tensor, Tensor)")
_LIB.impl("dedup_sum", dedup_sum_cuda, "CUDA")
_LIB.impl("dedup_sum", dedup_sum_plain, "CPU")
_LIB.impl("dedup_sum", _dedup_sum_meta, "Meta")


def dedup_sum(ids: torch.Tensor, g: torch.Tensor,
              scale: Optional[float] = None, drop_marker: int = -1,
              bag_sizes: Optional[Sequence[int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows, totals)`` of the lookups ``ids`` (M, nnz) whose rows are
    ``scale * g[m]``, or of per-feature bags with ``bag_sizes`` (module
    notes): the kernel for CUDA tensors, the plain version for CPU ones,
    through the op ``param_tpu_torch::dedup_sum``."""
    scale = None if scale is None else float(scale)
    if bag_sizes is None:
        return torch.ops.param_tpu_torch.dedup_sum.default(
            ids, g, scale, int(drop_marker))
    return torch.ops.param_tpu_torch.dedup_sum.default(
        ids, g, scale, int(drop_marker), [int(n) for n in bag_sizes])
