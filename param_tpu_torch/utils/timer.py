"""Timers: CUDA events on the card, ``perf_counter`` on the host.

A host clock around asynchronous CUDA work measures the enqueue, so device
timing uses ``torch.cuda.Event`` pairs and synchronises before reading.
One window of calls can be disturbed by its neighbours on the card or the
host, so a timing is the median of ``reps`` windows.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List, Optional

import torch


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
    synchronise with the host."""
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
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
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
