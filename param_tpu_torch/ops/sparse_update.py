"""Sparse row updates for the DLRM sparse-optimizer steps (port of
``param_tpu/ops/sparse_update.py``).

:func:`sparse_row_update` runs K2 (:mod:`param_tpu_torch.kernels.
sparse_update`) on a CUDA table and its plain version on a CPU table; both
update the table in place.  The kernel takes any row width, so the
reference's lane repacking (``pack_rows_to_lanes``) and ``D % 128`` guard,
which answer the TPU's DMA alignment, are not ported.

Contract: ``idx`` holds each row id at most once (:func:`dedup_row_updates`
segment-sums duplicates first, which Adagrad needs anyway: duplicate
gradients sum before squaring).  Ids outside [0, R) are dropped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from param_tpu_torch.kernels.sparse_update import sparse_update
from param_tpu_torch.utils.profiler import count, recording


def adagrad_factor(acc_new: torch.Tensor, eps: float) -> torch.Tensor:
    """The optax ``scale_by_rss`` factor ``where(acc > 0, rsqrt(acc + eps),
    0)``: eps inside the square root, gated on a positive accumulator."""
    return torch.where(acc_new > 0, torch.rsqrt(acc_new + eps),
                       torch.zeros_like(acc_new))


def dedup_row_updates(flat_idx: torch.Tensor, rows_g: torch.Tensor,
                      drop_marker: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse duplicate row ids: stable sort, run detection, segment sum.

    flat_idx (N,) int32 row ids; rows_g (N, D) per-occurrence updates.
    Returns (rows, totals): rows (N,) int32 with the unique ids as a prefix
    and ``drop_marker`` in the empty tail, totals (N, D) summed per row
    (zero in the tail).  Static shapes and no host synchronisation: no
    ``torch.unique``.  While a profiler runs, the number of runs is added
    to the counter ``dlrm.unique_rows`` as a device scalar."""
    N = flat_idx.shape[0]
    order = torch.argsort(flat_idx, stable=True)
    sidx = flat_idx[order]
    sg = rows_g[order]
    start = torch.ones(N, dtype=torch.bool, device=flat_idx.device)
    start[1:] = sidx[1:] != sidx[:-1]
    run_id = torch.cumsum(start, 0) - 1  # (N,) in [0, N)
    if N and recording():
        count("dlrm.unique_rows", run_id[-1] + 1)
    totals = torch.zeros_like(rows_g).index_add_(0, run_id, sg)
    rows = torch.full((N,), drop_marker, dtype=torch.int32,
                      device=flat_idx.device)
    # every member of a run carries the same id, so the scatter is exact
    rows.scatter_(0, run_id, sidx.to(torch.int32))
    return rows, totals


def sparse_row_update(table: torch.Tensor, idx: torch.Tensor,
                      upd: torch.Tensor, acc: Optional[torch.Tensor] = None,
                      *, lr: float = 0.01, eps: float = 1e-7):
    """In-place sparse row update on a flat (R, D) table.

    - SGD (``acc is None``): ``table[idx] += upd`` (pre-scale upd by -lr);
      returns ``table``.
    - Adagrad: ``acc[idx] += upd**2; table[idx] -= lr * upd *
      where(acc > 0, rsqrt(acc + eps), 0)``; returns ``(table, acc)``.

    Unlike the reference, which returns new (donated) arrays, the given
    tensors are modified and returned."""
    sparse_update(table, idx, upd, acc, lr=lr, eps=eps)
    return table if acc is None else (table, acc)
