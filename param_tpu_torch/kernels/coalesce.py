"""K9 and K10: the coalesced-fetch experiment's kernels
(``csrc/coalesce.cu``) and their plain PyTorch versions.

- K9 :func:`desc_fetch`: for tile t, ``n_desc = rows_per_tile // k`` row
  starts; fetch k consecutive table rows per start as ONE copy; return the
  f32 sum over every fetched row and column of the tile, (n_tiles, D).  A
  start outside [0, R - k] makes its tile NaN.  Counterpart of
  ``scripts/coalesce_experiment.py::_desc_kernel`` (``desc_fetch``).
- K10 :func:`coalesced_bag`: the sum-pooled bag (K1's function) through
  the experiment's mechanism: :func:`coalesce_plan` sorts each tile's ids
  and dedups them into aligned ``r_blk``-row blocks (the reference's XLA
  pre-pass), and the kernel fetches each distinct block once with one copy,
  then re-gathers and sums the rows per bag.  Counterpart of
  ``scripts/coalesce_experiment.py::_arena_kernel`` (``coalesced_bag``).
  As in K1 an id in [-R, 0) counts from the end and any other id outside
  [0, R) makes its bag NaN.  Its plain version is K1's,
  ``emb_gather_plain``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts
from param_tpu_torch.kernels.emb_gather import emb_gather_plain

_THREADS = 256
_ARENA_BYTES = 48 * 1024  # K10: one of the two arena buffers


class CoalescePlan(NamedTuple):
    """The pre-pass's output for ``batch // tile_bags`` tiles of ``rpt =
    tile_bags * nnz`` ids each.  Per tile: ``blocks`` the start rows of its
    distinct ``r_blk``-row blocks in ascending order (then 0), ``n_blocks``
    their count; per id in sorted order, ``flat`` its row in the tile's
    block list (slot * r_blk + id % r_blk; -1 for an id outside [-R, R),
    which sorts last) and ``order`` its position in the tile (bag * nnz +
    j).  All int32."""

    blocks: torch.Tensor    # (n_tiles, rpt)
    n_blocks: torch.Tensor  # (n_tiles,)
    flat: torch.Tensor      # (n_tiles, rpt)
    order: torch.Tensor     # (n_tiles, rpt)
    num_rows: int
    nnz: int
    tile_bags: int
    r_blk: int


def _tiles(idx: torch.Tensor, r_blk: int, tile_bags: int):
    """(n_tiles, ids a tile) of (B, nnz) ids, after the reference's shape
    rules."""
    if idx.dim() != 2:
        raise ValueError(f"idx (B, nnz) expected, got {tuple(idx.shape)}")
    batch, nnz = idx.shape
    if r_blk < 1 or tile_bags < 1 or batch % tile_bags:
        raise ValueError(f"batch {batch} must be a multiple of tile_bags "
                         f"{tile_bags} (and r_blk {r_blk} >= 1)")
    return batch // tile_bags, tile_bags * nnz


def coalesce_plan(idx: torch.Tensor, num_rows: int, r_blk: int = 8,
                  tile_bags: int = 16) -> CoalescePlan:
    """Per-tile sort, block dedup and arena offsets of (B, nnz) ids, on
    ``idx``'s device (``coalesce_experiment.py:237-252``).  No host sync, so
    it can be captured in a CUDA graph."""
    n_tiles, rpt = _tiles(idx, r_blk, tile_bags)
    nnz = idx.shape[1]
    ids = idx.reshape(n_tiles, rpt).long()
    ids = torch.where(ids < 0, ids + num_rows, ids)
    valid = (ids >= 0) & (ids < num_rows)
    key = torch.where(valid, ids, torch.full_like(ids, num_rows))
    srt, order = torch.sort(key, dim=1, stable=True)
    ok = srt < num_rows
    blk = srt // r_blk
    new = ok.clone()
    new[:, 1:] &= blk[:, 1:] != blk[:, :-1]
    slot = new.long().cumsum(1) - 1
    # each block's first id writes its start into its slot; the others
    # write into a dropped last column
    dest = torch.where(new, slot, torch.full_like(slot, rpt))
    blocks = torch.zeros((n_tiles, rpt + 1), dtype=torch.long,
                         device=idx.device)
    blocks.scatter_(1, dest, blk * r_blk)
    flat = torch.where(ok, slot * r_blk + srt % r_blk,
                       torch.full_like(slot, -1))
    return CoalescePlan(blocks[:, :rpt].int().contiguous(),
                        new.sum(1).int(), flat.int(), order.int(), num_rows,
                        nnz, tile_bags, r_blk)


# ------------------------------------------------------------------- K9
def _desc_shape(table: torch.Tensor, starts: torch.Tensor, k: int,
                rows_per_tile: int):
    """(n_tiles, n_desc) after the reference's shape rules."""
    if table.dim() != 2 or starts.dim() != 1:
        raise ValueError(f"table (R, D) and starts (N,) expected, got "
                         f"{tuple(table.shape)} and {tuple(starts.shape)}")
    if k < 1 or rows_per_tile % k:
        raise ValueError(f"k {k} must divide rows_per_tile {rows_per_tile}")
    n_desc = rows_per_tile // k
    if starts.shape[0] % n_desc:
        raise ValueError(f"{starts.shape[0]} starts do not make whole tiles "
                         f"of {n_desc}")
    return starts.shape[0] // n_desc, n_desc


def desc_fetch_plain(table: torch.Tensor, starts: torch.Tensor, k: int,
                     rows_per_tile: int = 4096) -> torch.Tensor:
    """Plain PyTorch version: gather ``starts[:, None] + arange(k)``, then
    an f32 sum per tile."""
    n_tiles, n_desc = _desc_shape(table, starts, k, rows_per_tile)
    s = starts.long()
    ok = (s >= 0) & (s + k <= table.shape[0])
    rows = s.clamp(0, max(table.shape[0] - k, 0))[:, None] + \
        torch.arange(k, device=starts.device)
    got = table[rows].float().reshape(n_tiles, n_desc * k, -1).sum(1)
    bad = ~ok.reshape(n_tiles, n_desc).all(1)
    return torch.where(bad[:, None], torch.full_like(got, float("nan")), got)


def desc_fetch_cuda(table: torch.Tensor, starts: torch.Tensor, k: int,
                    rows_per_tile: int = 4096) -> torch.Tensor:
    """Launch K9 on ``table``'s CUDA device."""
    n_tiles, n_desc = _desc_shape(table, starts, k, rows_per_tile)
    if table.dtype != torch.float32 or starts.dtype != torch.int32:
        raise TypeError(f"K9 takes an f32 table and int32 starts, got "
                        f"{table.dtype} and {starts.dtype}")
    if starts.device != table.device:
        raise ValueError("table and starts must share a device")
    if not (table.is_contiguous() and starts.is_contiguous()):
        raise ValueError("K9 takes contiguous tensors")
    dim = table.shape[1]
    if dim % 4 or _THREADS % (dim // 4) or table.data_ptr() % 16:
        raise ValueError(f"K9 takes a 16-byte aligned table whose width "
                         f"divides into float4s over {_THREADS} threads, got "
                         f"D = {dim}")
    spc = max(1, 32 // k)  # starts per chunk: about 32 rows or one start
    if not bindings.entry("coalesce", "desc_fetch_smem")(dim, k, spc):
        raise ValueError(f"K9: k {k} x D {dim} rows do not fit its four "
                         f"shared-memory buffers")
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    n_chunks = math.ceil(n_desc / spc)
    splits = max(1, min(round(8 * sms / max(n_tiles, 1)), n_chunks // 2))
    partial = torch.empty((n_tiles, splits, dim), dtype=torch.float32,
                          device=table.device)
    out = torch.empty((n_tiles, dim), dtype=torch.float32, device=table.device)
    fn = bindings.entry("coalesce", "desc_fetch_f32")
    rc = fn(table.data_ptr(), starts.data_ptr(), partial.data_ptr(),
            out.data_ptr(), table.shape[0], dim, k, n_tiles, n_desc, spc,
            splits, bindings.stream_of(table))
    bindings.check(rc, "desc_fetch")
    launch_counts["desc_fetch"] += 1
    return out


def desc_fetch(table: torch.Tensor, starts: torch.Tensor, k: int,
               rows_per_tile: int = 4096) -> torch.Tensor:
    """K9 for a CUDA table, the plain version for a CPU table."""
    if table.device.type == "cuda":
        return desc_fetch_cuda(table, starts, k, rows_per_tile)
    if table.device.type == "cpu":
        return desc_fetch_plain(table, starts, k, rows_per_tile)
    raise ValueError(f"unsupported device {table.device}")


# ------------------------------------------------------------------ K10
def arena_blocks(r_blk: int, dim: int) -> int:
    """Blocks K10 fetches per round into each of its two arena buffers."""
    return max(1, min(32, _ARENA_BYTES // (r_blk * dim * 4)))


def coalesced_bag_cuda(table: torch.Tensor, plan: CoalescePlan) -> torch.Tensor:
    """Launch K10 on ``table``'s CUDA device."""
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"K10 takes an (R, D) f32 table, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if table.shape[0] != plan.num_rows:
        raise ValueError(f"the plan was made for {plan.num_rows} rows, the "
                         f"table has {table.shape[0]}")
    arrays = (plan.blocks, plan.n_blocks, plan.flat, plan.order)
    for t in (table,) + arrays:
        if t.device != table.device or not t.is_contiguous():
            raise ValueError("K10 takes contiguous tensors on one device")
    dim = table.shape[1]
    if dim % 4 or table.data_ptr() % 16:
        raise ValueError(f"K10 takes a 16-byte aligned table with D % 4 == "
                         f"0, got D = {dim}")
    n_tiles, rpt = plan.flat.shape
    n_arena = arena_blocks(plan.r_blk, dim)
    if not bindings.entry("coalesce", "coalesced_bag_smem")(
            dim, plan.nnz, plan.tile_bags, plan.r_blk, n_arena):
        raise ValueError(f"K10: a tile of {rpt} ids with r_blk {plan.r_blk} "
                         f"and D {dim} does not fit in shared memory")
    out = torch.empty((n_tiles * plan.tile_bags, dim), dtype=torch.float32,
                      device=table.device)
    fn = bindings.entry("coalesce", "coalesced_bag_f32")
    rc = fn(table.data_ptr(), *(t.data_ptr() for t in arrays), out.data_ptr(),
            table.shape[0], dim, n_tiles, plan.nnz, plan.tile_bags, plan.r_blk,
            n_arena, bindings.stream_of(table))
    bindings.check(rc, "coalesced_bag")
    launch_counts["coalesced_bag"] += 1
    return out


def coalesced_bag(table: torch.Tensor, idx: torch.Tensor, r_blk: int = 8,
                  tile_bags: int = 16) -> torch.Tensor:
    """The sum-pooled bag of (B, nnz) ids: on the card the pre-pass
    (:func:`coalesce_plan`) then K10; on the CPU K1's plain version, the
    same function (the ids' tiling is still checked)."""
    if table.device.type == "cuda":
        return coalesced_bag_cuda(
            table, coalesce_plan(idx, table.shape[0], r_blk, tile_bags))
    if table.device.type == "cpu":
        _tiles(idx, r_blk, tile_bags)
        return emb_gather_plain(table, idx)
    raise ValueError(f"unsupported device {table.device}")
