"""Ragged sparse-input redistribution, the DLRM SparseDataDist (port of
``param_tpu/models/ragged.py``).

The reference's two-stage exchange (``train/comms/pt/dlrm.py:744-855``): an
all-to-all of per-bag LENGTHS, then one of the variable-length INDICES,
regrouped per table.  Bags of any length up to ``K`` route correctly: each
entry's place follows from masked prefix sums over the lengths.  Two wires:

- ``"padded"``: one all-to-all of a fixed capacity (b * T/n * K entries) a
  peer pair, which moves padded bytes;
- ``"ragged"``: an all-gather of the (n, n) send counts, then
  ``all_to_all_single`` with per-peer split sizes, which moves the true
  counts (what ``lax.ragged_all_to_all`` computes).  The split sizes reach
  the host, so this wire synchronises with the device.

Every function runs on one rank of ``group`` (a
:class:`~param_tpu_torch.backend.base.CommGroup`).  The layout is the
fixed-nnz model's: table t lives on rank t // (T/n), and the exchanged
batch is in (source rank, local sample) order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from param_tpu_torch.models.dlrm import all_to_all_tables


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def ragged_sparse_dist(lengths: torch.Tensor, idx_padded: torch.Tensor,
                       group, *, pad_row: int, wire: str = "padded"):
    """Send every local sample's ids for table t to t's owner.

    Args (this rank's values):
      lengths:    (b, T) int32, valid ids per (sample, table), <= K
      idx_padded: (b, T, K) int32 ids; positions >= the length are ignored
      pad_row:    the id that fills the invalid slots of the output (a
                  zero row, see ``ops.embedding.with_pad_row``)
      wire:       "padded" | "ragged"

    Returns:
      lengths_t: (B, T/n) int32, the lengths of this rank's tables
      idx_t:     (B, T/n, K) int32 ids of this rank's tables, padded with
                 ``pad_row``
    """
    if wire not in ("padded", "ragged"):
        raise ValueError(f"unknown wire {wire!r}")
    pg, n = group.pg, group.size
    b, T, K = idx_padded.shape
    tl = T // n
    cap = b * tl * K  # the most entries one rank sends one peer
    dev = idx_padded.device
    slot = torch.arange(K, device=dev)

    # stage 1: the lengths' all-to-all (comm 1, "offset exchange")
    lengths_t = all_to_all_tables(lengths, pg, n)  # (B, tl)

    # sender: the valid ids, destination-major, then (sample, local table,
    # slot): the order the receiver rebuilds in
    idx_d = idx_padded.reshape(b, n, tl, K).transpose(0, 1)
    len_d = lengths.reshape(b, n, tl).transpose(0, 1)
    mask = (slot < len_d[..., None]).reshape(n, -1)
    vals = idx_d.reshape(n, -1)[mask]

    if wire == "ragged":
        counts = mask.sum(1)
        mx = counts.new_empty(n * n)
        dist.all_gather_into_tensor(mx, counts, group=pg)
        mx = mx.view(n, n).tolist()  # [sender][dest]
        me = dist.get_rank(pg)
        send_sizes = mx[me]
        recv_sizes = [row[me] for row in mx]
        recv = vals.new_empty(sum(recv_sizes))
        dist.all_to_all_single(recv, vals, recv_sizes, send_sizes, group=pg)
        recv_off = _exclusive_cumsum(
            torch.tensor(recv_sizes, device=dev), 0)
    else:
        pos = torch.arange(n, device=dev)[:, None] * cap \
            + _exclusive_cumsum(mask.long(), 1)
        send = idx_padded.new_zeros(n * cap)
        send[pos[mask]] = vals
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=pg)
        recv_off = torch.arange(n, device=dev) * cap

    # receiver: rebuild the dense (B, tl, K) ids; the entries from sender r
    # follow the same masked prefix sum over r's rows of lengths_t
    mask_t = slot < lengths_t.reshape(n, b, tl)[..., None]
    flat = mask_t.reshape(n, -1)
    src = recv_off[:, None] + _exclusive_cumsum(flat.long(), 1)
    recv = torch.cat([recv, recv.new_zeros(1)])  # a slot for the invalid
    src = torch.where(flat, src, recv.shape[0] - 1)
    idx_t = recv[src].masked_fill(~flat, pad_row).reshape(n * b, tl, K)
    return lengths_t, idx_t


def ragged_reference(lengths, idx_padded, n: int, pad_row: int):
    """numpy oracle for the tests: what each rank's (lengths_t, idx_t) must
    be after a correct redistribution.  lengths / idx are the GLOBAL
    (B, T[, K]) arrays; returns one pair per rank."""
    B, T, K = idx_padded.shape
    tl = T // n
    out = []
    for j in range(n):
        lt = lengths[:, j * tl:(j + 1) * tl]
        # batch order (source rank, local sample) is the natural order
        it = np.full((B, tl, K), pad_row, dtype=idx_padded.dtype)
        for gi in range(B):
            for t in range(tl):
                L = int(lt[gi, t])
                it[gi, t, :L] = idx_padded[gi, j * tl + t, :L]
        out.append((lt, it))
    return out
