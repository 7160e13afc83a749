"""K3: tiled GEMM and K4: weight-resident stacked GEMM (``csrc/gemm.cu``),
with their plain PyTorch versions.

K3: ``C = A @ B`` for (M, K) @ (K, N) in f32, bf16 or f16 (both operands of
one dtype), f32 accumulation, ``C`` in ``out_dtype`` (default ``A``'s).
bf16/f16 run on the tensor cores (``mma.sync``), f32 on the CUDA cores in
full f32.  Counterpart of ``param_tpu/ops/matmul.py::_mm_kernel``
(``matmul_pallas``).

K4: S GEMMs (S, M, K) @ (K, N) against one shared B, computed as the
stacked (S*M, K) @ (K, N) with a block order that keeps B's column slice in
L2.  Counterpart of ``::_mm_wres_kernel`` (``matmul_weight_resident``).
"""

from __future__ import annotations

from typing import Optional

import torch

from param_tpu_torch.kernels import bindings, launch_counts

_COUNTER = {torch.float32: "gemm_f32", torch.bfloat16: "gemm_bf16",
            torch.float16: "gemm_f16"}


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: f32 product of the operands, cast once."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"(M, K) @ (K, N) expected, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in _COUNTER or b.dtype != a.dtype:
        raise TypeError(f"the GEMM kernels take two f32, bf16 or f16 "
                        f"operands of one dtype, got {a.dtype} and {b.dtype}")
    if out_dtype not in bindings.DTYPE_CODES:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    if a.device != b.device:
        raise ValueError("a and b must share a device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the GEMM kernels take contiguous operands")
    if max(a.shape[0], b.shape[1], a.shape[1]) >= 2**31 or \
            a.shape[0] >= 65535 * 128 or b.shape[1] >= 65535 * 128:
        raise ValueError("GEMM dimensions out of the kernel's range")


def _launch(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
            rows_fastest: bool) -> torch.Tensor:
    _check(a, b, out_dtype)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    aligned = (k % 8 == 0 and n % 8 == 0 and a.data_ptr() % 16 == 0
               and b.data_ptr() % 16 == 0)
    rc = bindings.entry("gemm", "gemm_launch")(
        bindings.DTYPE_CODES[a.dtype], bindings.DTYPE_CODES[out_dtype],
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(aligned),
        int(rows_fastest), bindings.stream_of(a))
    bindings.check(rc, "gemm")
    return out


def gemm_cuda(a: torch.Tensor, b: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch K3 on ``a``'s CUDA device."""
    out = _launch(a, b, out_dtype or a.dtype, rows_fastest=False)
    if out.numel():
        launch_counts[_COUNTER[a.dtype]] += 1
    return out


def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K3 for CUDA operands, the plain version for CPU operands."""
    if a.device.type == "cuda":
        return gemm_cuda(a, b, out_dtype)
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    raise ValueError(f"unsupported device {a.device}")


def _stacked(a_stack: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a_stack.dim() != 3:
        raise ValueError(f"(S, M, K) stack expected, got {tuple(a_stack.shape)}")
    s, m, k = a_stack.shape
    return a_stack.reshape(s * m, k)


def gemm_wres_plain(a_stack: torch.Tensor, b: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K4: (S, M, K) @ (K, N) -> (S, M, N)."""
    s, m, _ = a_stack.shape
    out = gemm_plain(_stacked(a_stack, b), b, out_dtype or a_stack.dtype)
    return out.reshape(s, m, b.shape[1])


def gemm_wres_cuda(a_stack: torch.Tensor, b: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch K4 on ``a_stack``'s CUDA device."""
    s, m, _ = a_stack.shape
    out = _launch(_stacked(a_stack, b).contiguous(), b,
                  out_dtype or a_stack.dtype, rows_fastest=True)
    if out.numel():
        launch_counts["gemm_wres"] += 1
    return out.reshape(s, m, b.shape[1])


def gemm_wres(a_stack: torch.Tensor, b: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K4 for CUDA operands, the plain version for CPU operands."""
    if a_stack.device.type == "cuda":
        return gemm_wres_cuda(a_stack, b, out_dtype)
    if a_stack.device.type == "cpu":
        return gemm_wres_plain(a_stack, b, out_dtype)
    raise ValueError(f"unsupported device {a_stack.device}")
