"""One rank of a run: the program set up from the seed, its checked first
steps, and the measured window.

The program is the ``Program`` of the configuration's model family
(``models/<model>.py``, found by ``spec.model``): built on this rank, it
takes train steps on a ring of batches (``step``), reads its first three
for ``check.py`` (``checked_steps``) and counts the work of the traced steps
(``trace_counts``).  This module warms the step up, sizes the window from
the warm step time, and times every step of the window by CUDA events at
consecutive step ends.  At most two steps are in flight, as a trainer that
reads its losses keeps them.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time
from typing import Callable, List

import torch

from port_bench import spec, trace

IN_FLIGHT = 2
WARM_STEPS = 3
SIZING_STEPS = 8
TRACED_STEPS = 10
FORBIDDEN = ("jax", "jaxlib", "flax", "param_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class _Marks:
    """Step-end stamps: CUDA events on the card, the host clock on the CPU
    (where the harness is only exercised, never timed)."""

    def __init__(self, device, n: int):
        self.cuda = device.type == "cuda"
        self.ev = ([torch.cuda.Event(enable_timing=True) for _ in range(n)]
                   if self.cuda else [0.0] * n)

    def record(self, i: int) -> None:
        if self.cuda:
            self.ev[i].record()
        else:
            self.ev[i] = time.perf_counter()

    def wait(self, i: int) -> None:
        if self.cuda:
            self.ev[i].synchronize()

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.ev, self.ev[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.ev, self.ev[1:])]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_step_s(prog) -> float:
    """Warm the step up, then time a few steps by the host clock."""
    for _ in range(WARM_STEPS):
        prog.step()
    sync(prog.device)
    t0 = time.perf_counter()
    for _ in range(SIZING_STEPS):
        prog.step()
    sync(prog.device)
    return (time.perf_counter() - t0) / SIZING_STEPS


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def window(prog, n_steps: int, traced: bool) -> dict:
    """The measured window of ``n_steps`` steps.  With ``traced``, a steady
    run of steps in its middle is profiled, each step named in the trace
    (``trace.STEP_TAG``).  The profiler starts ``IN_FLIGHT`` steps before
    them, so that the step before the traced ones is in the trace, and
    stops once the last has ended on the device; the steps around it are
    left out of the host and step-time statistics that the trace run
    reports."""
    dev = prog.device
    marks = _Marks(dev, n_steps + 1)
    seg = range(0)
    if traced:
        s0 = max(IN_FLIGHT + 2, n_steps // 3)
        seg = range(s0, s0 + max(1, min(TRACED_STEPS, n_steps - s0 - 2)))
    prof_on, prof_off = seg.start - IN_FLIGHT, seg.stop + IN_FLIGHT - 1
    prof = _profiler(dev) if traced else None
    host_ms, losses = [], []
    first = prog.done
    sync(dev)
    t_wall = time.time()
    t0 = time.perf_counter()
    marks.record(0)
    for i in range(n_steps):
        if i >= IN_FLIGHT:
            marks.wait(i + 1 - IN_FLIGHT)
        if traced and i == prof_on:
            prof.start()
        if traced and i == prof_off:  # step seg.stop - 1 has ended
            prof.stop()
        h0 = time.perf_counter()
        if traced and prof_on <= i < prof_off:
            with torch.profiler.record_function(f"{trace.STEP_TAG}{i}"):
                losses.append(prog.step())
        else:
            losses.append(prog.step())
        host_ms.append((time.perf_counter() - h0) * 1e3)
        marks.record(i + 1)
    sync(dev)
    t1 = time.perf_counter()
    step_ms = marks.intervals_ms()
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum())
    out = {"n_steps": n_steps, "window_s": t1 - t0, "t_window_start": t_wall,
           "step_ms": step_ms, "nonfinite": nonfinite,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    if traced:
        quiet = [i for i in range(n_steps)
                 if not prof_on - 1 <= i <= prof_off + 1]
        out["host_ms"] = [host_ms[i] for i in quiet]
        out["quiet_device_ms"] = [step_ms[i] for i in quiet]
        out["traced_steps"] = len(seg)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            out["trace"] = trace.summary(trace.device_ops(path),
                                         seg.start, seg.stop - 1)
        finally:
            os.remove(path)
        out.update(prog.trace_counts(
            [(first + i) % len(prog.ring) for i in seg]))
    return out


def run_rank(cell, seed: int, seconds: float, traced: bool, rank: int,
             world: int, group, device,
             agree: Callable[[float], float] = lambda x: x) -> dict:
    """Set up, read the checked steps, size and run the window on this
    rank.  ``agree`` makes one number the same on every rank (the largest).
    ``setup_marks`` holds the host clock at the end of each part of set-up,
    for the look at where set-up goes."""
    marks = {"rank_start": time.time()}
    prog = spec.model(cell.config["model"]).Program(cell, seed, rank, world,
                                                    group, device)
    sync(device)
    marks["program"] = time.time()
    readings = prog.checked_steps()
    marks["checked_steps"] = time.time()
    n_steps = max(IN_FLIGHT + 16, math.ceil(seconds / agree(warm_step_s(prog))))
    if group is not None:
        agree(0.0)  # every rank ready: the window starts together
    marks["warm"] = time.time()
    out = window(prog, n_steps, traced)
    out["readings"] = readings
    out["setup_marks"] = marks
    out["forbidden"] = forbidden_modules()
    return out
