"""K5: x @ group-int4 W (``csrc/int4_gemm.cu``) and its plain PyTorch
version.

``packed`` (K/2, N) int8 holds two weights per byte along K: row 2i in the
low nibble, stored +8-biased (``(b & 15) - 8``), row 2i+1 in the high
nibble (``b >> 4``, arithmetic); ``scale`` (K/g, N) f32 scales packed row i
by ``scale[i // (g/2)]``.  ``x`` (M, K) is bf16.  Each weight is
dequantized in f32 and the product accumulated in f32; the output is in
``out_dtype`` (default bf16).  Counterpart of
``param_tpu/ops/matmul.py::_mm_int4_kernel`` (``matmul_int4``).

Four hand-written paths, picked from the shape before the launch by
:func:`int4_schedule` (the tensor-core paths sum each scale group's exact
integer products in f32 and then scale them in f32):

- ``stream`` (M <= 32, aligned): the weight stream through cp.async rings,
  the weight as the tensor-core A operand (swap AB: mma.sync at M <= 8,
  wgmma with A in registers at M 9-32), split K reduced in the same launch;
- ``wgmma`` (M > 32, aligned, g a multiple of 64): a TMA ring, a transform
  warpgroup that dequantizes each packed tile once into K3's B layout, two
  consumer warpgroups on wgmma, split K reduced in the same launch;
- ``mma_sync`` (N % 16 != 0 or unaligned bases): mma.sync on 16-row x
  tiles, split K reduced by a second kernel;
- ``simt`` (g not a multiple of 16): the FMA core, in f32.

Launch counters: ``int4_gemm`` (every launch) and ``int4_gemm_<path>``.
:func:`forced_path` makes every launch in a block take one path (tests, and
timing the first design, ``mma_sync``, beside the schedule).
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache
from typing import Dict, Optional, Tuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts

_MMA_ROWS, _MMA_COLS = 16, 512  # x rows and columns of one block


def int4_dequant(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The (K, N) f32 weights of a packed int4 matrix."""
    kh, n = packed.shape
    p = packed.to(torch.int32)
    s = scale.float().repeat_interleave(kh // scale.shape[0], dim=0)
    w = torch.empty((2 * kh, n), dtype=torch.float32, device=packed.device)
    w[0::2] = ((p & 15) - 8).float() * s
    w[1::2] = (p >> 4).float() * s
    return w


def int4_gemm_plain(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: f32 dequantized weights, f32 product."""
    out = torch.matmul(x.float(), int4_dequant(packed, scale))
    return out.to(out_dtype or x.dtype)


# path -> code of csrc/int4_gemm.cu's int4_gemm_hopper (stream and wgmma)
PATHS = {"stream": 0, "wgmma": 1, "mma_sync": None, "simt": None}
STREAM_MAX_M = 32    # the stream path's largest M (T), from timings
# stream blocks an SM that the K splits aim at: the mma.sync kernel (M <= 8)
# and the wgmma one (M 9-32), from the splits' timings on the H100
_STREAM_WAVES = {8: 2, 16: 3, 32: 3}
_SPLIT_ROWS = 64     # stream K splits are whole multiples of this
_WGMMA_ROWS = 32     # packed rows of a wgmma K step
_WGMMA_M = _WGMMA_N = 128  # a wgmma tile
_COUNTERS = 4096     # per-tile arrival counters kept for each stream
_forced: Optional[str] = None  # the path forced_path sets, if any


@lru_cache(maxsize=None)
def mma_schedule(m: int, n: int, kh: int, sms: int):
    """(packed rows per K split, K splits) of the mma_sync path: about
    four blocks per SM, splits a multiple of 8 rows (one k16 step)."""
    tiles = math.ceil(m / _MMA_ROWS) * math.ceil(n / _MMA_COLS)
    splits = max(1, math.ceil(4 * sms / tiles))
    rows = max(8, math.ceil(kh / splits / 8) * 8)
    return rows, math.ceil(kh / rows)


def stream_tile(m: int) -> Tuple[int, int]:
    """(rows of x, columns) of a stream block: 8 rows (M <= 8, mma.sync's
    n8), else 16 or 32 (wgmma's N), and 128 columns."""
    mr = 8 if m <= 8 else 16 if m <= 16 else 32
    return mr, 128


def stream_split_cap(m: int, gh: int) -> int:
    """The most packed rows a stream split may take.  At M <= 8 the block
    keeps its split's x rows (8 rows of 2 x rows bf16 each) and scale rows
    in shared memory: within 16 KiB and 16 rows.  Above, x and the scales
    stream with the weights: no cap."""
    if stream_tile(m)[0] > 8:
        return 1 << 30
    by_x = 512
    by_scale = 14 * gh // _SPLIT_ROWS * _SPLIT_ROWS
    return max(_SPLIT_ROWS, min(by_x, by_scale))


@lru_cache(maxsize=None)
def _path_schedule(path: str, m: int, n: int, kh: int, gh: int, sms: int):
    """(packed rows per K split, K splits, output tiles) of ``path``."""
    if path == "simt":
        return kh, 1, 0
    if path == "mma_sync":
        return (*mma_schedule(m, n, kh, sms), 0)
    if path == "stream":
        # splits in whole _SPLIT_ROWS, aiming at _STREAM_WAVES blocks an SM
        mr, bn = stream_tile(m)
        tiles = math.ceil(m / mr) * math.ceil(n / bn)
        units = math.ceil(kh / _SPLIT_ROWS)
        fewest = math.ceil(kh / stream_split_cap(m, gh))
        # the f32 partial sums, written and read once, stay within half
        # the packed weight's bytes: splits M N 4 <= K/2 N / 2
        most = max(fewest, kh // (8 * m))
        want = min(units, most,
                   max(fewest, round(sms * _STREAM_WAVES[mr] / tiles)))
        if mr > 8:  # the wgmma kernel: a power of two (timed best)
            want = 1 << (want.bit_length() - 1)
        per = math.ceil(units / want)
        return per * _SPLIT_ROWS, math.ceil(units / per), tiles
    # wgmma: one block an SM; split K only when the tiles do not fill the
    # card, into as many parts as fit in one wave, the fewest that give
    # that many K steps a split
    tiles = math.ceil(m / _WGMMA_M) * math.ceil(n / _WGMMA_N)
    steps = kh // _WGMMA_ROWS
    if tiles >= sms or steps <= 1:
        return kh, 1, tiles
    per = math.ceil(steps / min(steps, sms // tiles))
    return per * _WGMMA_ROWS, math.ceil(steps / per), tiles


def takes(path: str, gh: int, aligned: bool) -> bool:
    """Whether ``path`` can compute a product with packed rows per group
    ``gh``; ``aligned``: N % 16 == 0, K % 8 == 0 and x, packed and scale
    16-byte aligned (what 16-byte copies and TMA take)."""
    if path == "simt":
        return True
    if path == "mma_sync":
        return gh % 8 == 0
    if path == "stream":
        return aligned and gh % 8 == 0
    return aligned and gh % _WGMMA_ROWS == 0


@lru_cache(maxsize=None)
def int4_schedule(m: int, n: int, kh: int, gh: int, aligned: bool,
                  sms: int) -> Tuple[str, int, int]:
    """(path, packed rows per K split, K splits) of K5 for an (M, K) @ int4
    (K, N) product with ``gh`` packed rows per scale group, on a card of
    ``sms`` SMs.

    ``simt`` when gh % 8 != 0 (a group is not whole k16 steps); else
    ``mma_sync`` unless ``aligned`` (see :func:`takes`); else ``stream`` up
    to M = STREAM_MAX_M (the weight stream bounds it), ``wgmma`` above it
    when gh % 32 == 0 (whole K steps of 64 per group), ``mma_sync``
    otherwise.  K splits cover K in whole steps (64 packed rows on the
    stream path, 32 a wgmma step, 8 an mma_sync k16 step), none of them
    empty."""
    if gh % 8:
        path = "simt"
    elif not aligned:
        path = "mma_sync"
    elif m <= STREAM_MAX_M:
        path = "stream"
    elif gh % _WGMMA_ROWS == 0:
        path = "wgmma"
    else:
        path = "mma_sync"
    rows, splits, _ = _path_schedule(path, m, n, kh, gh, sms)
    return path, rows, splits


@contextlib.contextmanager
def forced_path(path: str):
    """Within the block every K5 launch takes ``path`` instead of the one
    :func:`int4_schedule` picks, with that path's own K splits, and raises
    where ``path`` cannot take the product (:func:`takes`).
    ``forced_path("mma_sync")`` runs the first design (the mma.sync kernel
    and its reduce kernel) through any caller, a decode step included."""
    global _forced
    if path not in PATHS:
        raise ValueError(f"unknown K5 path {path!r}; one of {list(PATHS)}")
    outer, _forced = _forced, path
    try:
        yield
    finally:
        _forced = outer


# (card, stream) -> that stream's per-tile arrival counters
_counter_bufs: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """The zeroed per-tile arrival counters of split-K launches on
    ``stream``.  Launches on one stream run one after another and each
    leaves the counters zeroed, so no two launches that overlap share
    them.  They are never reallocated, since a captured CUDA graph keeps
    their address, and are made by the stream's first split-K launch,
    which must not be under capture (the zero fill would run only when the
    graph does)."""
    key = (device.index, stream)
    buf = _counter_bufs.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "K5: a split-K launch on a stream under CUDA-graph capture "
                "needs one launch on that stream before the capture (it "
                "sets up the stream's arrival counters)")
        buf = _counter_bufs[key] = torch.zeros(
            _COUNTERS, dtype=torch.int32, device=device)
    return buf


def int4_gemm_cuda(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch K5 on ``x``'s CUDA device and current stream, on the path
    :func:`int4_schedule` picks (or :func:`forced_path` sets).

    Split K on the stream and wgmma paths counts each output tile's
    arrivals in counters kept per stream (:func:`_counters`): launches on
    different streams may overlap.  A CUDA graph's launches use the
    counters of the stream it was captured on, so a graph must not replay
    while another replay of a graph captured on that stream, or an eager
    launch on that stream, is in flight."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError("x (M, K), packed (K/2, N) and scale (K/g, N) "
                         "expected")
    (m, k), (kh, n) = x.shape, packed.shape
    groups = scale.shape[0]
    if k != 2 * kh or scale.shape[1] != n or groups == 0 or kh % groups:
        raise ValueError(f"inconsistent int4 shapes: x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if x.dtype != torch.bfloat16 or packed.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise TypeError("K5 takes bf16 x, int8 packed and f32 scale, got "
                        f"{x.dtype}, {packed.dtype}, {scale.dtype}")
    if out_dtype not in bindings.DTYPE_CODES:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    for t in (packed, scale):
        if t.device != x.device:
            raise ValueError("x, packed and scale must share a device")
    if not all(t.is_contiguous() for t in (x, packed, scale)):
        raise ValueError("K5 takes contiguous tensors")
    if max(m * k, kh * n, m * n) >= 2**31 or m >= 65535 * 128:
        raise ValueError("int4 GEMM dimensions out of the kernel's range")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    gh, code = kh // groups, bindings.DTYPE_CODES[out_dtype]
    aligned = (n % 16 == 0 and k % 8 == 0 and x.data_ptr() % 16 == 0
               and packed.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    sms = bindings.sm_count(x.device.index)
    path = _forced
    if path is None:
        path, rows, splits = int4_schedule(m, n, kh, gh, aligned, sms)
    elif not takes(path, gh, aligned):
        raise ValueError(f"K5's {path} path does not take this product "
                         f"(gh {gh}, aligned {aligned})")
    else:
        rows, splits, _ = _path_schedule(path, m, n, kh, gh, sms)
    stream = bindings.stream_of(x)
    if path == "simt":
        rc = bindings.entry("int4_gemm", "int4_gemm_tiled")(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            code, m, n, kh, gh, stream)
    else:
        # f32 partial sums: mma_sync's per split (its reduce kernel adds
        # them), the others' when they split K
        partial = (torch.empty((splits, m, n), dtype=torch.float32,
                               device=x.device)
                   if splits > 1 or path == "mma_sync" else None)
        if path == "mma_sync":
            if x.data_ptr() % 4:
                raise ValueError("K5 takes x 4-byte aligned")
            vec = n % 16 == 0 and packed.data_ptr() % 16 == 0
            rc = bindings.entry("int4_gemm", "int4_gemm_mma")(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                partial.data_ptr(), out.data_ptr(), code, m, n, kh, gh, rows,
                splits, int(vec), stream)
        else:
            counters = None
            if partial is not None:
                if _path_schedule(path, m, n, kh, gh, sms)[2] > _COUNTERS:
                    raise ValueError("K5: too many split output tiles")
                counters = _counters(x.device, stream).data_ptr()
            rc = bindings.entry("int4_gemm", "int4_gemm_hopper")(
                PATHS[path], x.data_ptr(), packed.data_ptr(),
                scale.data_ptr(), out.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                counters, code, m, n, kh, gh, rows, splits, stream)
    bindings.check(rc, f"int4_gemm {path} (shape {(m, n, k)})")
    launch_counts["int4_gemm"] += 1
    launch_counts[f"int4_gemm_{path}"] += 1
    return out


def int4_gemm(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K5 for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return int4_gemm_cuda(x, packed, scale, out_dtype)
    if x.device.type == "cpu":
        return int4_gemm_plain(x, packed, scale, out_dtype)
    raise ValueError(f"unsupported device {x.device}")
