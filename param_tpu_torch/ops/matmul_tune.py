"""Analytic matmul time model + schedule tuner for K3 (port of
``param_tpu/ops/matmul_tune.py``).

The analogue of the reference's Triton autotune pipeline
(``train/comms/pt/triton_matmul.py`` autotune configs +
``matmul_perf_model.py::estimate_matmul_time`` pruning): candidate
schedules are enumerated, ranked by an analytic ``max(compute, load) +
store`` time model, and only the top few are measured on the card.

The JAX package tunes the Pallas GEMM's block shapes.  K3's tiles are
compiled in (``kernels/gemm.py::_PATHS``), so the port tunes what K3 takes
at launch (:class:`~param_tpu_torch.kernels.gemm.GemmSchedule`): the path
(``wgmma`` or ``mma_sync`` for 16-bit operands, ``simt`` for f32), the
number of K splits and the block order.

Model (the JAX model's terms on ``utils/chip.H100``): compute ``2*M*N*K``
at the dtype's peak; A reloaded ``ceil(N/bn)`` times and B ``ceil(M/bm)``
times; C stored once.  Added for Hopper: the compute time is divided by the
last wave's fill (blocks over whole waves of one block an SM), and split K
writes and reads an f32 ``splits x M x N`` workspace.  The JAX model's
derate for narrow tiles (an MXU fill) is dropped.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from param_tpu_torch.kernels.gemm import (
    _PATHS, GemmSchedule, aligned_operands, check_schedule, default_schedule,
    gemm,
)
from param_tpu_torch.utils.chip import H100, ChipSpec
from param_tpu_torch.utils.timer import time_samples

H100_SMS = 132  # streaming multiprocessors of the H100 SXM


@dataclass(frozen=True)
class ScheduleCandidate:
    path: str
    splits: int
    rows_fastest: bool
    est_us: float  # analytic estimate

    def schedule(self) -> GemmSchedule:
        return GemmSchedule(self.path, self.splits, self.rows_fastest)


def estimate_matmul_time_us(
    m: int, n: int, k: int,
    bm: int, bn: int, bk: int,
    dtsize: int = 2,
    chip: Optional[ChipSpec] = None,
    splits: int = 1,
    sms: int = H100_SMS,
) -> float:
    """Analytic microseconds of one (M, K) @ (K, N) product in ``bm`` x
    ``bn`` tiles: max(compute, device-memory loads) + C store + the split-K
    workspace (reference model shape: matmul_perf_model.py:71-171)."""
    chip = chip or H100
    peak = chip.bf16_flops if dtsize == 2 else chip.fp32_flops
    blocks = math.ceil(m / bm) * math.ceil(n / bn) * splits
    fill = blocks / (math.ceil(blocks / sms) * sms)
    compute_us = 2.0 * m * n * k / peak * 1e6 / fill
    loads = (m * k) * math.ceil(n / bn) + (k * n) * math.ceil(m / bm)
    load_us = loads * dtsize / chip.hbm_bytes_per_s * 1e6
    store_us = m * n * dtsize / chip.hbm_bytes_per_s * 1e6
    ws_us = (2 * splits * m * n * 4 / chip.hbm_bytes_per_s * 1e6
             if splits > 1 else 0.0)
    return max(compute_us, load_us) + store_us + ws_us


def _split_counts(k: int, k_step: int) -> List[int]:
    """Every split count that leaves no split empty (one per distinct
    number of K steps a split walks)."""
    steps = max(1, math.ceil(k / k_step))
    return sorted({math.ceil(steps / per) for per in range(1, steps + 1)})


def candidate_blocks(
    m: int, n: int, k: int,
    dtype: torch.dtype = torch.bfloat16,
    aligned: bool = True,
    top: int = 5,
    chip: Optional[ChipSpec] = None,
    sms: int = H100_SMS,
) -> List[ScheduleCandidate]:
    """The legal K3 schedules of an (M, K) @ (K, N) product of ``dtype``
    (:func:`~param_tpu_torch.kernels.gemm.check_schedule`: wgmma only when
    ``aligned``, mma_sync with one split, simt only for f32, no split empty,
    at most 65535 splits), ranked by :func:`estimate_matmul_time_us`, then
    fewer splits, then K3's own block order; the first ``top``."""
    dtsize = torch.empty((), dtype=dtype).element_size()
    if dtype == torch.float32:
        paths = ["simt"]
    else:
        paths = (["wgmma"] if aligned and k > 0 else []) + ["mma_sync"]
    cands = []
    for path in paths:
        bm, bn, bk = _PATHS[path][1]
        splits = [1] if path == "mma_sync" else _split_counts(k, bk)
        for s in splits:
            for rows_fastest in (False, True):
                try:
                    check_schedule((path, s, rows_fastest), m, n, k, dtype,
                                   aligned)
                except ValueError:
                    continue
                cands.append(ScheduleCandidate(
                    path, s, rows_fastest,
                    estimate_matmul_time_us(m, n, k, bm, bn, bk, dtsize,
                                            chip, s, sms)))
    cands.sort(key=lambda c: (round(c.est_us, 3), c.splits, c.rows_fastest,
                              paths.index(c.path)))
    return cands[:top]


def tune_matmul(
    a: torch.Tensor, b: torch.Tensor,
    candidates: Optional[Sequence[Tuple]] = None,
    reps: int = 3,
    iters: int = 10,
    out_dtype: Optional[torch.dtype] = None,
    top: int = 5,
) -> Tuple[GemmSchedule, Dict[GemmSchedule, float]]:
    """Time each candidate schedule of ``a @ b`` (default: the model's
    ``top`` finalists and :func:`~param_tpu_torch.kernels.gemm.
    gemm_schedule`'s own pick) in turns, ``reps`` rounds of one window of
    ``iters`` calls each, and return (best, {schedule: median us a call}).
    On the card a window is a CUDA-graph replay between CUDA events (the
    card's time, without the host's issue); on the CPU each schedule is
    checked as K3 would and the plain version runs, timed by
    ``perf_counter``."""
    (m, k), n = a.shape, b.shape[1]
    aligned = aligned_operands(a, b)
    if candidates is None:
        sms = (torch.cuda.get_device_properties(a.device).multi_processor_count
               if a.device.type == "cuda" else H100_SMS)
        candidates = [c.schedule() for c in
                      candidate_blocks(m, n, k, a.dtype, aligned, top, sms=sms)]
        dflt = default_schedule(m, n, k, a.dtype, aligned, sms)
        if dflt not in candidates:
            candidates.append(dflt)
    candidates = [check_schedule(c, m, n, k, a.dtype, aligned)
                  for c in candidates]
    if not candidates:
        raise ValueError(f"no legal schedule for {(m, n, k)}")
    graph = a.device.type == "cuda"
    samples: Dict[GemmSchedule, List[float]] = {c: [] for c in candidates}
    for _ in range(reps):
        for c in candidates:  # in turns across candidates
            samples[c] += time_samples(
                lambda c=c: gemm(a, b, out_dtype, schedule=c), iters,
                a.device, warmup=1, graph=graph)
    medians = {c: statistics.median(v) * 1e3 for c, v in samples.items()}
    best = min(medians, key=medians.get)
    return best, medians
