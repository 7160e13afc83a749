"""K1: sum-pooled embedding bag (``csrc/emb_gather.cu``) and its plain
PyTorch version.

``out[b] = sum_j w[b, j] * table[idx[b, j]]`` accumulated in f32 and cast to
the table's dtype; ``w`` is 1 when no weights are given.  As in the
reference's ``jnp.take``, an id in [-R, 0) counts from the end and any other
id outside [0, R) makes its bag NaN.  Counterpart of
``param_tpu/ops/embedding.py::_emb_gather_kernel`` (``embedding_bag_pallas``).

Bags of per-feature sizes: with ``bag_sizes`` (T sizes, L = their sum),
``idx`` is (B, L), one row of ids a sample, feature t's bag its slice
``[o_t, o_t + size_t)``, o_t the sizes before it; the output is (B * T, D),
bag ``b * T + t`` at row ``b * T + t``.  One launch reads exactly the B * L
real ids, with no pad slot (:func:`bag_layout` holds the offsets on the
device).

K1 is the PyTorch op ``torch.ops.param_tpu_torch.emb_gather`` (registered
with ``torch.library.Library``, not ``custom_op``, whose Python dispatch
costs several times more a call): its CUDA kernel is the launch, its CPU
kernel the plain version, its Meta kernel the output's shape.  So a
dispatcher-level recorder (``make_fx``) sees one ``param_tpu_torch::
emb_gather`` node, where it could not see a ctypes launch, and the replay
of that node launches K1 on the card.

:func:`emb_gather_schedule` picks the launch's shape (lanes a row, row
loads in flight, warps a bag) from the shapes alone; :func:`forced_schedule`
overrides it within a block (the timings' sweep of the design's steps,
``experiments/emb_gather_timings.py``).
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts

_DTYPES = {torch.float32: "emb_gather_f32", torch.bfloat16: "emb_gather_bf16"}

BLOCK_WARPS = 8  # csrc/emb_gather.cu's kBlockThreads / 32
WARPS_PER_BAG = (1, 2, 4, 8)  # the kernel's k: warps splitting one bag
ROWS_IN_FLIGHT = (1, 2, 4, 8)  # the kernel's U: compiled row-load depths
# warps an SM keeps at 8 f32 row loads in flight a lane group (64
# registers a thread, 4 blocks of 8 warps); at 1 (32 registers) it keeps 64
WAVE_WARPS = 32


class EmbSchedule(NamedTuple):
    """K1's launch shape.  ``lanes_per_row`` lanes read a row in ``vec``
    -element loads, so a warp is ``32 // lanes_per_row`` lane groups; each
    group issues ``rows_in_flight`` row loads before it adds them;
    ``warps_per_bag`` warps split a bag's ids and add their partial sums
    through ``smem_bytes`` of shared memory; a block of ``BLOCK_WARPS``
    warps sums ``bags_per_block`` bags, ``blocks`` blocks in all.  With
    one warp a bag, at most one id a lane group and a row in one pass of
    the warp, the launch takes the kernel's short path instead (each group
    loads its own id and row)."""

    warps_per_bag: int
    rows_in_flight: int
    lanes_per_row: int
    bags_per_block: int
    blocks: int
    smem_bytes: int


def _launch_shape(batch: int, dim: int, vec: int, warps_per_bag: int,
                  rows_in_flight: int) -> EmbSchedule:
    vecs = dim // vec
    lanes = (vecs if dim % vec == 0 and 0 < vecs <= 32 and 32 % vecs == 0
             else 32)
    per_block = BLOCK_WARPS // warps_per_bag
    return EmbSchedule(warps_per_bag, rows_in_flight, lanes, per_block,
                       math.ceil(batch / per_block),
                       4 * per_block * (warps_per_bag - 1) * lanes * vec)


@lru_cache(maxsize=None)
def emb_gather_schedule(batch: int, nnz: int, dim: int, elem_size: int,
                        sms: int, vec: Optional[int] = None) -> EmbSchedule:
    """K1's launch shape for ``batch`` bags of ``nnz`` ids over a table of
    ``dim`` columns of ``elem_size`` bytes on a card of ``sms`` SMs, read in
    ``vec``-element loads (default: 16-byte loads where ``dim`` allows).

    One wave is ``sms * WAVE_WARPS`` warps.  When the bags are fewer than
    that, each is split over k warps (a power of two, at most 8) while the warps still
    fit in that wave and every lane group keeps 4 rows of its slice.  A
    group issues as many row loads before it adds as its slice's first 32
    ids give it, rounded up to a compiled depth, at most 8; but where the
    warps overflow one wave, 16-bit rows take one load at a time, since
    there 64 warps an SM at 32 registers beat 32 warps at depth 4 or 8
    (``experiments/emb_gather_timings.py --sweep``; f32 rows are the other
    way round)."""
    if vec is None:
        vec = 16 // elem_size if dim % (16 // elem_size) == 0 else 1
    lanes = _launch_shape(batch, dim, vec, 1, 1).lanes_per_row
    groups = 32 // lanes
    wave = sms * WAVE_WARPS
    k = 1
    while (2 * k <= WARPS_PER_BAG[-1] and batch * 2 * k <= wave
           and nnz >= 2 * k * groups * 4):
        k *= 2
    if batch * k > wave and elem_size == 2:
        return _launch_shape(batch, dim, vec, k, 1)
    rows = math.ceil(min(math.ceil(nnz / k), 32) / groups)
    u = min(ROWS_IN_FLIGHT[-1], 1 << max(rows - 1, 0).bit_length())
    return _launch_shape(batch, dim, vec, k, u)


_forced: Optional[Tuple[Optional[int], Optional[int]]] = None


@contextlib.contextmanager
def forced_schedule(warps_per_bag: Optional[int] = None,
                    rows_in_flight: Optional[int] = None):
    """Within the block every K1 launch takes these warps a bag and / or
    rows in flight in place of :func:`emb_gather_schedule`'s (``None``
    keeps its pick).  For timing the design's steps against each other;
    the sums are the same function, in another order."""
    global _forced
    if warps_per_bag is not None and warps_per_bag not in WARPS_PER_BAG:
        raise ValueError(f"warps_per_bag must be one of {WARPS_PER_BAG}")
    if rows_in_flight is not None and rows_in_flight not in ROWS_IN_FLIGHT:
        raise ValueError(f"rows_in_flight must be one of {ROWS_IN_FLIGHT}")
    outer, _forced = _forced, (warps_per_bag, rows_in_flight)
    try:
        yield
    finally:
        _forced = outer


def launch_schedule(table: torch.Tensor, batch: int, nnz: int,
                    vec: int) -> EmbSchedule:
    """The schedule a K1 launch on ``table``'s card takes: the pick of
    :func:`emb_gather_schedule`, or what :func:`forced_schedule` sets."""
    D = table.shape[1]
    s = emb_gather_schedule(batch, nnz, D, table.element_size(),
                            bindings.sm_count(table.device.index), vec)
    if _forced is None:
        return s
    k, u = _forced
    return _launch_shape(batch, D, vec, k or s.warps_per_bag,
                         u or s.rows_in_flight)


_LAYOUTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def check_bag_sizes(bag_sizes: Sequence[int], ids_a_sample: int) -> None:
    if not bag_sizes or min(bag_sizes) < 0:
        raise ValueError(f"bag sizes must be one or more sizes >= 0, got "
                         f"{list(bag_sizes)}")
    if sum(bag_sizes) != ids_a_sample:
        raise ValueError(f"bag sizes {list(bag_sizes)} sum to "
                         f"{sum(bag_sizes)}, not the {ids_a_sample} ids a "
                         f"sample")


def bag_layout(bag_sizes: Sequence[int], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets (T + 1,) int32, features (L,) int32) of per-feature bags
    of ``bag_sizes`` on ``device``: feature t's bag is ids [offsets[t],
    offsets[t + 1]) of a sample's row, and column j of the row belongs to
    feature features[j].  Made once a layout and device (a copy from the
    host), then cached."""
    key = (tuple(int(n) for n in bag_sizes), str(torch.device(device)))
    out = _LAYOUTS.get(key)
    if out is None:
        sizes = torch.tensor(key[0], dtype=torch.int32)
        offsets = torch.zeros(len(key[0]) + 1, dtype=torch.int32)
        torch.cumsum(sizes, 0, out=offsets[1:])
        feats = torch.repeat_interleave(
            torch.arange(len(key[0]), dtype=torch.int32), sizes.long())
        out = _LAYOUTS[key] = (offsets.to(device), feats.to(device))
    return out


def per_feature(x: torch.Tensor, bag_sizes: Sequence[int]) -> torch.Tensor:
    """(B * T, ...) rows of per-feature bags -> (B, L, ...): each id's
    column takes its bag's row."""
    T = len(bag_sizes)
    feats = bag_layout(bag_sizes, x.device)[1]
    return x.reshape(-1, T, *x.shape[1:]).index_select(1, feats.long())


def normalize_ids(idx: torch.Tensor, num_rows: int):
    """(ids wrapped into [0, R) where they were in [-R, R), valid mask)."""
    i = idx.long()
    i = torch.where(i < 0, i + num_rows, i)
    valid = (i >= 0) & (i < num_rows)
    return i.clamp(0, max(num_rows - 1, 0)), valid


def emb_gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gathered rows (B, nnz, D), NaN where an id is outside [-R, R)."""
    i, valid = normalize_ids(idx, table.shape[0])
    rows = table[i]
    return torch.where(valid[..., None], rows, torch.full_like(rows, float("nan")))


def emb_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     bag_sizes: Optional[Sequence[int]] = None
                     ) -> torch.Tensor:
    """Plain PyTorch version: gather, optional weighting, f32 sum over
    each bag's ids (with ``bag_sizes``, each feature's columns in order)."""
    rows = emb_gather_rows(table, idx)  # (B, nnz, D)
    if weights is not None:
        rows = rows * weights[..., None]
    if bag_sizes is None:
        return rows.float().sum(dim=1).to(table.dtype)
    check_bag_sizes(bag_sizes, idx.shape[1])
    B, T, D = idx.shape[0], len(bag_sizes), table.shape[1]
    feats = bag_layout(bag_sizes, idx.device)[1].long()
    out = torch.zeros((B, T, D), dtype=torch.float32, device=table.device)
    return out.index_add_(1, feats, rows.float()).reshape(B * T, D).to(
        table.dtype)


def emb_gather_cuda(table: torch.Tensor, idx: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    bag_sizes: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """Launch K1 on ``table``'s CUDA device.  With ``bag_sizes`` (module
    notes) the launch shape is picked for bags of the mean size."""
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"table (R, D) and idx (B, nnz) expected, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"K1 takes f32 or bf16 tables, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"K1 takes int32 indices, got {idx.dtype}")
    tensors = [table, idx] + ([weights] if weights is not None else [])
    for t in tensors:
        if t.device != table.device:
            raise ValueError("table, idx and weights must share a device")
        if not t.is_contiguous():
            raise ValueError("K1 takes contiguous tensors")
    if weights is not None and (weights.shape != idx.shape
                                or weights.dtype != torch.float32):
        raise ValueError("weights must be f32 with idx's shape")
    B, nnz = idx.shape
    R, D = table.shape
    if B * nnz >= 2**31:
        raise ValueError("K1 takes fewer than 2**31 lookups")
    offsets, nfeat, bags, bag_nnz = None, 1, B, nnz
    if bag_sizes is not None:
        check_bag_sizes(bag_sizes, nnz)
        nfeat = len(bag_sizes)
        bags, bag_nnz = B * nfeat, -(-nnz // nfeat)
        offsets = bag_layout(bag_sizes, table.device)[0]
    out = torch.empty((bags, D), dtype=table.dtype, device=table.device)
    vec = bindings.vec_width(D, table.element_size(), table, out)
    s = launch_schedule(table, bags, bag_nnz, vec)
    fn = bindings.entry("emb_gather", _DTYPES[table.dtype])
    rc = fn(table.data_ptr(), idx.data_ptr(),
            weights.data_ptr() if weights is not None else None,
            out.data_ptr(), R, bags, nnz, D, vec, s.lanes_per_row,
            s.warps_per_bag, s.rows_in_flight,
            None if offsets is None else offsets.data_ptr(), nfeat,
            bindings.stream_of(table))
    bindings.check(rc, "emb_gather")
    launch_counts["emb_gather"] += 1
    return out


def _emb_gather_meta(table: torch.Tensor, idx: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     bag_sizes: Optional[Sequence[int]] = None
                     ) -> torch.Tensor:
    bags = idx.shape[0] * (1 if bag_sizes is None else len(bag_sizes))
    return table.new_empty((bags, table.shape[1]))


_LIB = torch.library.Library("param_tpu_torch", "FRAGMENT")
_LIB.define("emb_gather(Tensor table, Tensor idx, Tensor? weights=None, "
            "int[]? bag_sizes=None) -> Tensor")
_LIB.impl("emb_gather", emb_gather_cuda, "CUDA")
_LIB.impl("emb_gather", emb_gather_plain, "CPU")
_LIB.impl("emb_gather", _emb_gather_meta, "Meta")


def emb_gather(table: torch.Tensor, idx: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               bag_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """K1 for a CUDA table, the plain version for a CPU table, through the
    op ``param_tpu_torch::emb_gather``; another device has no kernel and
    raises."""
    if bag_sizes is None:
        return torch.ops.param_tpu_torch.emb_gather.default(table, idx,
                                                            weights)
    return torch.ops.param_tpu_torch.emb_gather.default(
        table, idx, weights, [int(n) for n in bag_sizes])
