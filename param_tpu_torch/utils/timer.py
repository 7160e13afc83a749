"""Timers: CUDA events on the card, ``perf_counter`` on the host.

A host clock around asynchronous CUDA work measures the enqueue, so device
timing uses ``torch.cuda.Event`` pairs and synchronises before reading.
One window of calls can be disturbed by its neighbours on the card or the
host, so a timing is the median of ``reps`` windows.

:class:`ParamTimer`, :func:`param_profile` and :class:`RegionTimers` are
the benches' accumulating host-clock timers (PARAM's ``paramTimer`` and
``paramProfile``); they measure the host, not the card.
"""

from __future__ import annotations

import statistics
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, List, Optional

import torch


@dataclass
class ParamTimer:
    """Accumulating nanosecond timer."""

    elapsed_ns: float = 0.0

    def reset(self, new_ns: float = 0.0) -> None:
        self.elapsed_ns = new_ns

    def inc_ns(self, ns: float) -> None:
        self.elapsed_ns += ns

    def get_us(self) -> float:
        return self.elapsed_ns / 1e3

    def get_ms(self) -> float:
        return self.elapsed_ns / 1e6

    def get_s(self) -> float:
        return self.elapsed_ns / 1e9


@contextmanager
def param_profile(timer: Optional[ParamTimer] = None, description: str = ""):
    """A named ``torch.profiler`` region (``record_function``) whose host
    wall time (``time.monotonic_ns``) is added to ``timer``.  The time is
    the host's: CUDA work the body only enqueued is not in it."""
    start = time.monotonic_ns()
    try:
        with torch.profiler.record_function(description or "param_profile"):
            yield
    finally:
        if timer is not None:
            timer.inc_ns(time.monotonic_ns() - start)


@dataclass
class RegionTimers:
    """A named set of :class:`ParamTimer` (the DLRM bench's timing
    regions)."""

    timers: dict = field(default_factory=dict)

    def get(self, name: str) -> ParamTimer:
        return self.timers.setdefault(name, ParamTimer())

    def reset_all(self) -> None:
        for t in self.timers.values():
            t.reset()

    def snapshot_us(self) -> dict:
        return {k: v.get_us() for k, v in self.timers.items()}


def time_samples(fn: Callable[[], object], iters: int, device="cuda",
                 warmup: Optional[int] = None, reps: int = 1,
                 graph: bool = False) -> List[float]:
    """Mean milliseconds per call of ``fn``, one value for each of ``reps``
    windows of ``iters`` calls, after ``warmup`` calls (default: one
    untimed window; on the H100 the first window after a pause ran up to
    14x slower than the next ones).  CUDA events on a CUDA device,
    ``perf_counter`` on the CPU.

    ``graph=True`` (CUDA only) captures the ``iters`` calls once into a CUDA
    graph and times its replays: the card's time for the launches back to
    back, without the host's cost of issuing them.  ``fn`` must then not
    synchronise with the host.  One call of ``fn`` on the capture stream
    comes first, so what a kernel keeps per stream (K5's split-K counters)
    exists before the capture."""
    dev = torch.device(device)
    for _ in range(iters if warmup is None else warmup):
        fn()
    out = []
    if dev.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / iters)
        return out
    torch.cuda.synchronize(dev)
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        side = _capture_stream(dev.index if dev.index is not None
                               else torch.cuda.current_device())
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.synchronize(dev)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            run()
        run = g.replay
        run()  # the first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(dev)
        out.append(start.elapsed_time(end) / iters)
    return out


@lru_cache(maxsize=None)
def _capture_stream(index: int) -> "torch.cuda.Stream":
    """The side stream on which :func:`time_samples` captures its graphs
    on card ``index``."""
    return torch.cuda.Stream(torch.device("cuda", index))


def time_ms(fn: Callable[[], object], iters: int, device="cuda",
            warmup: Optional[int] = None, reps: int = 1,
            graph: bool = False) -> float:
    """Median over ``reps`` windows of the mean milliseconds per call of
    ``fn`` (see :func:`time_samples`)."""
    return statistics.median(time_samples(fn, iters, device, warmup, reps,
                                          graph))


def sync(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
