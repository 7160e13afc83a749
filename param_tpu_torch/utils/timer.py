"""Timers: CUDA events on the card, ``perf_counter`` on the host.

A host clock around asynchronous CUDA work measures the enqueue, so device
timing uses ``torch.cuda.Event`` pairs and synchronises before reading.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def time_ms(fn: Callable[[], object], iters: int, device="cuda",
            warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls after
    ``warmup`` calls.  CUDA events on a CUDA device, ``perf_counter`` on the
    CPU."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def sync(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
