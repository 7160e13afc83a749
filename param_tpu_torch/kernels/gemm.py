"""K3: tiled GEMM and K4: weight-resident stacked GEMM (``csrc/gemm.cu``),
with their plain PyTorch versions.

K3: ``C = A @ B`` for (M, K) @ (K, N) in f32, bf16 or f16 (both operands of
one dtype), f32 products and accumulation, ``C`` in ``out_dtype`` (default
``A``'s).  Counterpart of ``param_tpu/ops/matmul.py::_mm_kernel``
(``matmul_pallas``).  Three hand-written paths, picked from the shape before
the launch by :func:`gemm_schedule`:

- ``wgmma``: bf16/f16 whose rows TMA can take (K and N multiples of 8, A
  and B 16-byte aligned): 128 x 256 tiles, TMA loads into a 4-stage ring,
  two consumer warpgroups on ``wgmma``;
- ``mma_sync``: other bf16/f16 shapes: 128 x 128 tiles on ``mma.sync``;
- ``simt``: f32 on the CUDA cores in full f32, 128 x 128 tiles.

``wgmma`` and ``simt`` split K when the output tiles do not fill the SMs:
each split writes an f32 partial into a workspace allocated here, and a
second kernel adds the splits in a fixed order and casts.  A caller may
pick the schedule instead (``schedule=`` a :class:`GemmSchedule`: path, K
splits, block order; checked by :func:`check_schedule`), as the schedule
tuner ``ops/matmul_tune`` does.  Launch counters:
``gemm_f32`` / ``gemm_bf16`` / ``gemm_f16`` per input dtype (K3),
``gemm_wres`` (K4), and ``gemm_wgmma`` / ``gemm_mma_sync`` for the 16-bit
path taken (K3 and K4).

K4: S GEMMs (S, M, K) @ (K, N) against one shared B, computed as the
stacked (S*M, K) @ (K, N) with a block order that keeps B's column slice in
L2.  Counterpart of ``::_mm_wres_kernel`` (``matmul_weight_resident``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts

_COUNTER = {torch.float32: "gemm_f32", torch.bfloat16: "gemm_bf16",
            torch.float16: "gemm_f16"}

# path -> (code in csrc/gemm.cu, (block M, block N, K step)); every path
# runs one block an SM
_PATHS = {"simt": (0, (128, 128, 16)), "mma_sync": (1, (128, 128, 32)),
          "wgmma": (2, (128, 256, 64))}


@lru_cache(maxsize=None)
def gemm_schedule(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool,
                  sms: int) -> Tuple[str, Tuple[int, int, int], int]:
    """(path, (block M, block N, K step), K splits) of K3 / K4 for an
    (M, K) @ (K, N) product.

    16-bit operands take ``wgmma`` exactly when ``aligned`` (K and N
    multiples of 8, both bases 16-byte aligned: what TMA takes) and K > 0,
    else ``mma_sync`` (one split); f32 takes ``simt``.  When the output
    tiles do not fill one wave (``sms`` blocks), K is split into as many
    parts as fit in that wave, so a block walks the fewest K steps; of the
    counts giving that many steps the fewest splits are taken (less
    workspace), so none is empty."""
    if dtype == torch.float32:
        path = "simt"
    elif aligned and k > 0:
        path = "wgmma"
    else:
        return "mma_sync", _PATHS["mma_sync"][1], 1
    bm, bn, bk = _PATHS[path][1]
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    steps = math.ceil(k / bk)
    if tiles >= sms or steps <= 1:
        return path, (bm, bn, bk), 1
    per = math.ceil(steps / min(steps, sms // tiles))
    return path, (bm, bn, bk), math.ceil(steps / per)


def k_split(k: int, k_step: int, splits: int) -> int:
    """Elements of K each split takes: whole K steps, the last split
    possibly shorter, none empty."""
    return math.ceil(math.ceil(k / k_step) / splits) * k_step if k else k_step


class GemmSchedule(NamedTuple):
    """What K3 takes at launch: its path, the K split count and the block
    order (``rows_fastest``: row tiles fastest, K4's order)."""

    path: str
    splits: int = 1
    rows_fastest: bool = False


def default_schedule(m: int, n: int, k: int, dtype: torch.dtype,
                     aligned: bool, sms: int) -> GemmSchedule:
    """:func:`gemm_schedule`'s pick, column tiles fastest (K3's order)."""
    path, _, splits = gemm_schedule(m, n, k, dtype, aligned, sms)
    return GemmSchedule(path, splits, False)


def check_schedule(schedule, m: int, n: int, k: int, dtype: torch.dtype,
                   aligned: bool) -> GemmSchedule:
    """``schedule`` as a :class:`GemmSchedule` if K3 can run it on an (M, K)
    @ (K, N) product of ``dtype``, else ``ValueError``: ``simt`` exactly for
    f32; ``wgmma`` only for ``aligned`` operands (what TMA reads) with K >
    0; ``mma_sync`` with one split; 1 to 65535 splits (grid.z), none
    empty."""
    path, splits, rows_fastest = GemmSchedule(*schedule)
    if path not in _PATHS:
        raise ValueError(f"unknown K3 path {path!r}; one of {sorted(_PATHS)}")
    if (path == "simt") != (dtype == torch.float32):
        raise ValueError(f"the {path} path does not take {dtype} operands")
    if path == "wgmma" and not (aligned and k > 0):
        raise ValueError("the wgmma path takes only operands TMA can read "
                         "(K and N multiples of 8, 16-byte aligned) with K > 0")
    if not isinstance(splits, int) or not 1 <= splits <= 65535:
        raise ValueError(f"K splits must be an int in [1, 65535], got {splits!r}")
    if path == "mma_sync" and splits != 1:
        raise ValueError("the mma_sync path takes one K split")
    if splits > 1 and (splits - 1) * k_split(k, _PATHS[path][1][2], splits) >= k:
        raise ValueError(f"{splits} K splits of K={k} leave a split empty")
    return GemmSchedule(path, splits, bool(rows_fastest))


def aligned_operands(a: torch.Tensor, b: torch.Tensor) -> bool:
    """K and N multiples of 16 bytes' worth of elements and both bases
    16-byte aligned: what the 16-bit TMA path reads."""
    vec = 16 // a.element_size()
    return (a.shape[1] % vec == 0 and b.shape[1] % vec == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


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
            rows_fastest: bool, schedule=None) -> torch.Tensor:
    """Launch ``schedule`` (validated by :func:`check_schedule`), or when it
    is None the path :func:`gemm_schedule` picks in ``rows_fastest`` order;
    returns C and counts the path's launch."""
    _check(a, b, out_dtype)
    (m, k), n = a.shape, b.shape[1]
    aligned = aligned_operands(a, b)
    if schedule is not None:
        path, splits, rows_fastest = check_schedule(schedule, m, n, k,
                                                    a.dtype, aligned)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if schedule is None:
        path, _, splits = gemm_schedule(m, n, k, a.dtype, aligned,
                                        bindings.sm_count(a.device.index))
    bk = _PATHS[path][1][2]
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    rc = bindings.entry("gemm", "gemm_launch")(
        bindings.DTYPE_CODES[a.dtype], bindings.DTYPE_CODES[out_dtype],
        _PATHS[path][0], a.data_ptr(), b.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k, int(aligned),
        splits, k_split(k, bk, splits), int(rows_fastest),
        bindings.stream_of(a))
    bindings.check(rc, f"gemm (shape {(m, n, k)})")
    if path != "simt":
        launch_counts[f"gemm_{path}"] += 1
    return out


def gemm_cuda(a: torch.Tensor, b: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None,
              schedule=None) -> torch.Tensor:
    """Launch K3 on ``a``'s CUDA device, on ``schedule`` (a
    :class:`GemmSchedule`, or None for :func:`gemm_schedule`'s pick)."""
    out = _launch(a, b, out_dtype or a.dtype, rows_fastest=False,
                  schedule=schedule)
    if out.numel():
        launch_counts[_COUNTER[a.dtype]] += 1
    return out


def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None,
         schedule=None) -> torch.Tensor:
    """K3 for CUDA operands, the plain version for CPU operands (after
    checking ``schedule``, when one is given, as the launch would)."""
    if a.device.type == "cuda":
        return gemm_cuda(a, b, out_dtype, schedule)
    if a.device.type == "cpu":
        if schedule is not None:
            _check(a, b, out_dtype or a.dtype)
            check_schedule(schedule, a.shape[0], b.shape[1], a.shape[1],
                           a.dtype, aligned_operands(a, b))
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
