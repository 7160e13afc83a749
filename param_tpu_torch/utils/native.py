"""ctypes bindings for the repo's native data-generation library.

Loads ``native/libparamdata.so`` (built with ``make -C native`` when it is
missing); every entry point has a numpy fallback.  This is host-side batch
generation, shared with ``param_tpu`` through the same C++ source, so both
packages produce identical batches from one seed.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libparamdata.so")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def build_native() -> bool:
    """Compile the library (``make -C native``); returns success."""
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log.warning("native build failed: %s", e)
        return False


def get_lib(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH) and auto_build:
        build_native()
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        log.warning("failed to load %s: %s", _LIB_PATH, e)
        return None
    i64, u64, f64 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_double
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.pd_uniform_indices.argtypes = [u64, i64, i64, p_i32]
    lib.pd_uniform_indices.restype = None
    lib.pd_zipf_make.restype = ctypes.c_void_p
    lib.pd_zipf_make.argtypes = [f64, i64]
    lib.pd_zipf_free.argtypes = [ctypes.c_void_p]
    lib.pd_zipf_free.restype = None
    lib.pd_zipf_sample.argtypes = [ctypes.c_void_p, u64, i64, p_i32]
    lib.pd_zipf_sample.restype = None
    lib.pd_ragged_offsets.argtypes = [u64, i64, i64, p_i64]
    lib.pd_ragged_offsets.restype = None
    lib.pd_normal.argtypes = [u64, i64, p_f32]
    lib.pd_normal.restype = None
    lib.pd_pad_ragged.argtypes = [p_i32, p_i64, i64, i64, ctypes.c_int32,
                                  p_i32]
    lib.pd_pad_ragged.restype = None
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def uniform_indices(seed: int, n_rows: int, shape) -> np.ndarray:
    """Uniform int32 indices in [0, n_rows)."""
    count = int(np.prod(shape))
    lib = get_lib()
    if lib is None:
        rng = np.random.default_rng(seed)
        return rng.integers(0, n_rows, size=shape).astype(np.int32)
    out = np.empty(count, dtype=np.int32)
    lib.pd_uniform_indices(seed, n_rows, count, out)
    return out.reshape(shape)


class ZipfSampler:
    """Bounded Zipf sampler with a cached native CDF table."""

    def __init__(self, alpha: float, n_rows: int):
        self.alpha = alpha
        self.n_rows = n_rows
        self._handle = None
        lib = get_lib()
        if lib is not None:
            self._handle = lib.pd_zipf_make(alpha, n_rows)

    def sample(self, seed: int, shape) -> np.ndarray:
        count = int(np.prod(shape))
        if self._handle is not None:
            out = np.empty(count, dtype=np.int32)
            get_lib().pd_zipf_sample(self._handle, seed, count, out)
            return out.reshape(shape)
        rng = np.random.default_rng(seed)
        z = rng.zipf(self.alpha, size=shape)
        return ((z - 1) % self.n_rows).astype(np.int32)

    def __del__(self):
        try:
            if self._handle is not None and _lib is not None:
                _lib.pd_zipf_free(self._handle)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
        self._handle = None


def ragged_offsets(seed: int, batch: int, max_nnz: int) -> np.ndarray:
    """CSR offsets (batch+1,) int64 with uniform bag lengths in
    [1, max_nnz]."""
    lib = get_lib()
    if lib is None:
        rng = np.random.default_rng(seed)
        lengths = rng.integers(1, max_nnz + 1, size=batch)
        return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    out = np.empty(batch + 1, dtype=np.int64)
    lib.pd_ragged_offsets(seed, batch, max_nnz, out)
    return out


def pad_ragged(indices: np.ndarray, offsets: np.ndarray, max_nnz: int,
               pad_value: int) -> np.ndarray:
    """CSR (indices, offsets) -> dense (batch, max_nnz) int32 bag matrix
    padded with ``pad_value``; bags longer than max_nnz are truncated."""
    batch = len(offsets) - 1
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lib = get_lib()
    if lib is not None:
        out = np.empty(batch * max_nnz, dtype=np.int32)
        lib.pd_pad_ragged(indices, offsets, batch, max_nnz, pad_value, out)
        return out.reshape(batch, max_nnz)
    lengths = np.minimum(np.diff(offsets), max_nnz)
    slot = np.arange(max_nnz, dtype=np.int64)
    mask = slot[None, :] < lengths[:, None]
    src = np.minimum(offsets[:-1, None] + slot[None, :], len(indices) - 1)
    out = np.full((batch, max_nnz), pad_value, dtype=np.int32)
    out[mask] = indices[src[mask]]
    return out


def normal(seed: int, shape) -> np.ndarray:
    """Standard-normal float32 features."""
    count = int(np.prod(shape))
    lib = get_lib()
    if lib is None:
        return np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    out = np.empty(count, dtype=np.float32)
    lib.pd_normal(seed, count, out)
    return out.reshape(shape)
