"""EmbeddingBag: sum-pooled sparse embedding lookup (port of
``param_tpu/ops/embedding.py``).

:func:`embedding_bag` runs K1 (:mod:`param_tpu_torch.kernels.emb_gather`) on
a CUDA table and its plain version on a CPU table.  Its backward is a plain
``index_add_`` scatter, as the reference's backward is a plain XLA scatter.

Ragged bags are padded to a fixed nnz with an index pointing at a zero pad
row appended to the table (:func:`with_pad_row`, :func:`pad_ragged_indices`).
The reference's ``pad_table_dim`` and chunked zero-scatter answer TPU limits
only and are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from param_tpu_torch.kernels.emb_gather import (
    emb_gather, emb_gather_rows, normalize_ids,
)


def embedding_bytes(batch: int, nnz: int, dim: int, elem_size: int = 4) -> int:
    """Bytes of table rows a sum-pooled lookup reads (one row per lookup)."""
    return batch * nnz * dim * elem_size


def pad_ragged_indices(
    indices: np.ndarray, offsets: np.ndarray, num_rows: int,
    max_nnz: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """CSR bags (indices, offsets) -> dense (batch, max_nnz) int32 indices
    whose padding points at row ``num_rows`` (the zero pad row)."""
    from param_tpu_torch.utils.native import pad_ragged

    full_offsets = np.append(offsets, len(indices)).astype(np.int64)
    lengths = np.diff(full_offsets)
    batch = len(lengths)
    if max_nnz is None:
        max_nnz = int(lengths.max()) if batch else 0
    out = pad_ragged(np.asarray(indices), full_offsets, max_nnz, num_rows)
    return out, max_nnz


def with_pad_row(table: torch.Tensor) -> torch.Tensor:
    """Append one zero row to serve as the padding target."""
    pad = torch.zeros((1, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad], dim=0)


def embedding_bag_grad(table: torch.Tensor, dense_indices: torch.Tensor,
                       grad_out: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backward of the sum-pooled lookup: ``dtable[idx[b, j]] +=
    w[b, j] * grad_out[b]`` into a zero table-shaped tensor.  Ids outside
    [-R, R) add nothing (their gradient is zeroed, so no host sync)."""
    nnz = dense_indices.shape[1]
    i, valid = normalize_ids(dense_indices.reshape(-1), table.shape[0])
    rows_g = grad_out.repeat_interleave(nnz, dim=0)  # (B*nnz, D)
    if weights is not None:
        rows_g = rows_g * weights.reshape(-1, 1)
    rows_g = torch.where(valid[:, None], rows_g, torch.zeros_like(rows_g))
    dtable = torch.zeros_like(table)
    dtable.index_add_(0, i, rows_g.to(table.dtype))
    return dtable


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, dense_indices, weights):
        ctx.save_for_backward(table, dense_indices, weights)
        return emb_gather(table, dense_indices, weights)

    @staticmethod
    def backward(ctx, g):
        table, idx, weights = ctx.saved_tensors
        dtable = dweights = None
        if ctx.needs_input_grad[0]:
            dtable = embedding_bag_grad(table, idx, g, weights)
        if weights is not None and ctx.needs_input_grad[2]:
            # the forward's rows: NaN for an id outside [-R, R)
            rows = emb_gather_rows(table, idx).float()  # (B, nnz, D)
            dweights = (rows * g.float()[:, None, :]).sum(-1).to(weights.dtype)
        return dtable, None, dweights


def embedding_bag(table: torch.Tensor, dense_indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum-pooled lookup ``out[b] = sum_j w[b, j] * table[idx[b, j]]``.

    ``table`` (R, D) f32 or bf16; ``dense_indices`` (B, nnz) int32 ids
    (in [-R, 0) counted from the end; other ids outside [0, R) make the bag
    NaN, as ``jnp.take`` does); ``weights`` optional (B, nnz) f32.
    Differentiable in ``table`` and ``weights``."""
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    return _EmbeddingBag.apply(table, dense_indices.contiguous(), weights)
