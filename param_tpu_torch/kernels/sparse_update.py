"""K2: in-place sparse row update (``csrc/sparse_update.cu``) and its plain
PyTorch version.

- SGD (``acc is None``): ``table[idx] += upd`` (scale ``upd`` by -lr first).
- Adagrad: ``acc[idx] += upd**2;
  table[idx] += (-lr * upd) * where(acc > 0, rsqrt(acc + eps), 0)``.

``idx`` (N,) int32 must be duplicate-free; ids outside [0, R) are dropped.
Counterpart of ``param_tpu/ops/sparse_update.py::_update_kernel``
(``sparse_row_update``).
"""

from __future__ import annotations

from typing import Optional

import torch

from param_tpu_torch.kernels import bindings, launch_counts


def sparse_update_plain(table: torch.Tensor, idx: torch.Tensor,
                        upd: torch.Tensor, acc: Optional[torch.Tensor] = None,
                        *, lr: float = 0.01, eps: float = 1e-7) -> None:
    """Plain PyTorch version; updates ``table`` (and ``acc``) in place."""
    R = table.shape[0]
    with torch.no_grad():
        keep = (idx >= 0) & (idx < R)
        rows = idx[keep].long()
        u = upd[keep].float()
        t = table[rows].float()
        if acc is None:
            table[rows] = (t + u).to(table.dtype)
            return
        a_new = acc[rows].float() + u * u
        factor = torch.where(a_new > 0, torch.rsqrt(a_new + eps),
                             torch.zeros_like(a_new))
        acc[rows] = a_new.to(acc.dtype)
        table[rows] = (t + (-lr * u) * factor).to(table.dtype)


def sparse_update_cuda(table: torch.Tensor, idx: torch.Tensor,
                       upd: torch.Tensor, acc: Optional[torch.Tensor] = None,
                       *, lr: float = 0.01, eps: float = 1e-7) -> None:
    """Launch K2 on ``table``'s CUDA device; updates in place."""
    if table.dim() != 2 or idx.dim() != 1 or upd.dim() != 2:
        raise ValueError("table (R, D), idx (N,) and upd (N, D) expected")
    R, D = table.shape
    N = idx.shape[0]
    if upd.shape != (N, D):
        raise ValueError(f"upd shape {tuple(upd.shape)} != {(N, D)}")
    if acc is not None and acc.shape != table.shape:
        raise ValueError("acc must have the table's shape")
    tensors = [table, idx, upd] + ([acc] if acc is not None else [])
    for t in tensors:
        if t.device != table.device:
            raise ValueError("table, idx, upd and acc must share a device")
        if not t.is_contiguous():
            raise ValueError("K2 takes contiguous tensors")
    floats = [table, upd] + ([acc] if acc is not None else [])
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("K2 takes f32 table, upd and acc")
    if idx.dtype != torch.int32:
        raise TypeError(f"K2 takes int32 row ids, got {idx.dtype}")
    if N >= 2**31:
        raise ValueError("K2 takes fewer than 2**31 updates")
    vec = bindings.vec_width(D, 4, *floats)
    stream = bindings.stream_of(table)
    if acc is None:
        fn = bindings.entry("sparse_update", "sparse_update_sgd_f32")
        rc = fn(table.data_ptr(), idx.data_ptr(), upd.data_ptr(), R, N, D,
                vec, stream)
        bindings.check(rc, "sparse_update_sgd")
        launch_counts["sparse_update_sgd"] += 1
    else:
        fn = bindings.entry("sparse_update", "sparse_update_adagrad_f32")
        rc = fn(table.data_ptr(), acc.data_ptr(), idx.data_ptr(),
                upd.data_ptr(), R, N, D, vec, lr, eps, stream)
        bindings.check(rc, "sparse_update_adagrad")
        launch_counts["sparse_update_adagrad"] += 1


def sparse_update(table: torch.Tensor, idx: torch.Tensor, upd: torch.Tensor,
                  acc: Optional[torch.Tensor] = None, *, lr: float = 0.01,
                  eps: float = 1e-7) -> None:
    """K2 for a CUDA table, the plain version for a CPU table."""
    if table.device.type == "cuda":
        return sparse_update_cuda(table, idx, upd, acc, lr=lr, eps=eps)
    if table.device.type == "cpu":
        return sparse_update_plain(table, idx, upd, acc, lr=lr, eps=eps)
    raise ValueError(f"unsupported device {table.device}")
