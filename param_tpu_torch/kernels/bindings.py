"""ctypes signatures of the kernels' C entry points, and launch helpers.

Pointers and the stream go as ``c_void_p`` (a plain int would be cut to 32
bits).  Every entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from param_tpu_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)

_SIGNATURES = {
    "emb_gather": {
        "emb_gather_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                           _P, _I, _P],
        "emb_gather_bf16": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                            _P, _I, _P],
    },
    "sparse_update": {
        "sparse_update_sgd_f32": [_P, _P, _P, _L, _I, _I, _I, _P],
        "sparse_update_adagrad_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _F,
                                      _F, _P],
    },
    "gemm": {
        "gemm_launch": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P],
    },
    "int4_gemm": {
        "int4_gemm_mma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P],
        "int4_gemm_tiled": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "int4_gemm_hopper": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    },
    "flash_fwd": {
        "flash_fwd_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I,
                             _I, _P],
    },
    "ring": {
        "ring_capacity": [_I, _I, _I, _I],
        "ring_cluster_capacity": [_I, _I, _I, _I],
        "ring_enable_peer": [_I, _I],
        "ring_launch": [_I, _I, _I, _I, _I, _I, _I, _LP, _LP, _LP, _LP, _L,
                        _L, _I, _I, _I, _I, _I, _I, _I, _L, _P, _P],
        "ring_flag_words": [],
        "ring_max_blocks": [],
    },
    "flash_bwd": {
        "flash_bwd_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _LP, _F, _I, _P],
    },
    "dedup": {
        "dedup_sum_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                          _I, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "interaction": {
        "dot_interaction_fwd": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "dot_interaction_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _P],
    },
    "coalesce": {
        "desc_fetch_smem": [_I, _I, _I],
        "coalesced_bag_smem": [_I, _I, _I, _I],
        "desc_fetch_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P],
        "coalesced_bag_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I,
                              _P],
    },
}

# dtype codes of the GEMM entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@lru_cache(maxsize=None)
def entry(lib_name: str, fn_name: str):
    """The C function ``fn_name`` of kernel library ``lib_name``, typed."""
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes = _SIGNATURES[lib_name][fn_name]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


# the entry points' own codes beside cudaError_t's (csrc/hopper.cuh)
TMA_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
              -2: "cuTensorMapEncodeTiled refused a TMA descriptor"}


def check(rc: int, what: str) -> None:
    if rc in TMA_ERRORS:
        raise RuntimeError(f"{what}: {TMA_ERRORS[rc]}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def vec_width(dim: int, elem_size: int, *tensors: torch.Tensor) -> int:
    """Elements per 16-byte vector access when the row width and every base
    pointer allow it, else 1."""
    vec = 16 // elem_size
    if dim % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec
