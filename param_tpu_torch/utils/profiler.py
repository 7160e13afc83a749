"""``torch.profiler`` traces for the CLIs' ``--profile DIR`` (torch
counterpart of ``param_tpu/utils/profiler.py``).

A trace goes to ``DIR/trace.json`` (Chrome / Perfetto format), and the top
operators by device time (by host time on the CPU) are printed.  The
profiler slows the host, so a profiled run gives device times, not step or
call times.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch


def make_profiler(device) -> torch.profiler.profile:
    """A profiler of host activity, and of the card's when ``device`` is a
    CUDA device; start and stop it around the window to trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def write_trace(prof, out_dir: str, on_cuda: bool) -> Optional[Tuple[float, int]]:
    """Write ``prof``'s trace to ``out_dir`` and print its top operators;
    returns (device microseconds, device operations) of the window, or None
    for a CPU run (device time not measured)."""
    from torch.autograd import DeviceType

    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    avgs = prof.key_averages()
    if not on_cuda:
        print(avgs.table(sort_by="self_cpu_time_total", row_limit=15))
        print("profile: CPU run, device time not measured")
        return None
    print(avgs.table(sort_by="self_device_time_total", row_limit=20))
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in dev_events), len(dev_events)


@contextlib.contextmanager
def profile_to(log_dir: Optional[str], device="cuda"):
    """Trace the body into ``log_dir`` when it is set (else do nothing) and
    print the device time of the whole window."""
    if not log_dir:
        yield
        return
    prof = make_profiler(device)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        totals = write_trace(prof, log_dir, torch.device(device).type == "cuda")
        if totals is not None:
            print(f"profile: {totals[0] / 1e3:.3f} ms of device time over "
                  f"{totals[1]} device operations; trace in {log_dir}")


def annotate(name: str) -> torch.profiler.record_function:
    """A named region of a ``torch.profiler`` trace (a context manager)."""
    return torch.profiler.record_function(name)


def kernel_times(run, calls: int = 10):
    """Device ms a call of ``run`` by kernel name (cut to 80 characters),
    from ``torch.profiler`` over ``calls`` calls after 3 warm-ups: their
    sum, and {name: {launches, ms} a call}, the longest first."""
    from torch.autograd import DeviceType

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name[:80]
            n, ms = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, ms + ev.self_device_time_total / 1e3)
    kernels = {k: dict(launches=n / calls, ms=ms / calls)
               for k, (n, ms) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])}
    return sum(v["ms"] for v in kernels.values()), kernels


class SizeTriggeredProfiler:
    """Starts tracing once a sweep reaches ``start_size`` bytes
    (``cli.comms --size-start-profiler``); :meth:`stop` writes the trace."""

    def __init__(self, log_dir: str, start_size: int, device="cuda"):
        self.log_dir = log_dir
        self.start_size = start_size
        self.device = device
        self.prof = None

    def maybe_start(self, size: int) -> None:
        if self.prof is None and size >= self.start_size:
            self.prof = make_profiler(self.device)
            self.prof.start()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            write_trace(self.prof, self.log_dir,
                        torch.device(self.device).type == "cuda")
            self.prof = None
