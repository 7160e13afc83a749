"""K1: sum-pooled embedding bag (``csrc/emb_gather.cu``) and its plain
PyTorch version.

``out[b] = sum_j w[b, j] * table[idx[b, j]]`` accumulated in f32 and cast to
the table's dtype; ``w`` is 1 when no weights are given.  As in the
reference's ``jnp.take``, an id in [-R, 0) counts from the end and any other
id outside [0, R) makes its bag NaN.  Counterpart of
``param_tpu/ops/embedding.py::_emb_gather_kernel`` (``embedding_bag_pallas``).
"""

from __future__ import annotations

from typing import Optional

import torch

from param_tpu_torch.kernels import bindings, launch_counts

_DTYPES = {torch.float32: "emb_gather_f32", torch.bfloat16: "emb_gather_bf16"}


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
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gather, optional weighting, f32 sum over nnz."""
    rows = emb_gather_rows(table, idx)  # (B, nnz, D)
    if weights is not None:
        rows = rows * weights[..., None]
    return rows.float().sum(dim=1).to(table.dtype)


def emb_gather_cuda(table: torch.Tensor, idx: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on ``table``'s CUDA device."""
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
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    vec = bindings.vec_width(D, table.element_size(), table, out)
    fn = bindings.entry("emb_gather", _DTYPES[table.dtype])
    rc = fn(table.data_ptr(), idx.data_ptr(),
            weights.data_ptr() if weights is not None else None,
            out.data_ptr(), R, B, nnz, D, vec, bindings.stream_of(table))
    bindings.check(rc, "emb_gather")
    launch_counts["emb_gather"] += 1
    return out


def emb_gather(table: torch.Tensor, idx: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 for a CUDA table, the plain version for a CPU table."""
    if table.device.type == "cuda":
        return emb_gather_cuda(table, idx, weights)
    if table.device.type == "cpu":
        return emb_gather_plain(table, idx, weights)
    raise ValueError(f"unsupported device {table.device}")
