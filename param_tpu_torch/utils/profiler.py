"""``torch.profiler`` traces for the CLIs' ``--profile DIR`` (torch
counterpart of ``param_tpu/utils/profiler.py``).

A trace goes to ``DIR/trace.json`` (Chrome / Perfetto format), and the top
operators by device time (by host time on the CPU) are printed.  The
profiler slows the host, so a profiled run gives device times, not step or
call times.

Spans and counters.  :func:`annotate` names a region of the program.  While
no ``torch.profiler`` runs it does nothing beyond that check.  While one
runs, a span is a ``record_function`` range (``user_annotation`` on the
host lane of the trace, ``gpu_user_annotation`` on the stream's lane) and a
record kept in memory: its name, its parent (the span open when it opened),
host start and end (``perf_counter_ns``), and a CUDA event pair on the
current stream (the host clock stands in on a process that has not
initialised CUDA).  No span synchronises: a closed outermost span is folded
into per-name totals once its events have completed, and
:func:`span_totals` waits for the rest; :func:`span_trees` keeps each of
the last outermost spans' device time by name.  :func:`count` adds to a named
counter while a profiler runs; a 0-d device tensor is summed on the device
and read by :func:`counter_totals`.  :func:`reset` empties the record.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

TREES_KEPT = 4096  # outermost spans whose breakdown span_trees keeps


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
    print the device time of the whole window.  The span record starts
    empty with the trace (:func:`reset`)."""
    if not log_dir:
        yield
        return
    prof = make_profiler(device)
    prof.start()
    reset()
    try:
        yield
    finally:
        prof.stop()
        totals = write_trace(prof, log_dir, torch.device(device).type == "cuda")
        if totals is not None:
            print(f"profile: {totals[0] / 1e3:.3f} ms of device time over "
                  f"{totals[1]} device operations; trace in {log_dir}")


def recording() -> bool:
    """Whether a ``torch.profiler`` runs, and so spans and counters record."""
    return torch._C._autograd._profiler_enabled()


_OFF = contextlib.nullcontext()  # the span of a run without a profiler


class _Span:
    """One span of the record (module notes); a context manager, or opened
    and closed by hand (:func:`annotate_backward`)."""

    __slots__ = ("name", "parent", "children", "rf", "t0", "t1", "ev0", "ev1")

    def __init__(self, name: str):
        self.name = name
        self.children: List["_Span"] = []
        self.rf = self.ev0 = self.ev1 = self.t1 = None

    def open(self) -> None:
        stack = _RECORD.stack
        self.parent = stack[-1] if stack else None
        if self.parent is not None:
            self.parent.children.append(self)
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        if self.rf is None or self.t1 is not None:  # never opened, or closed
            return
        stack = _RECORD.stack
        while self in stack:  # a child left open closes with its parent
            top = stack.pop()
            if top.ev1 is not None:
                top.ev1.record()
            top.t1 = time.perf_counter_ns()
            top.rf.__exit__(None, None, None)
        if self.parent is None:
            _RECORD.pending.append(self)
            _RECORD.fold(wait=False)

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Record:
    """The spans and counters recorded in this process since :func:`reset`."""

    def __init__(self):
        self.stack: List[_Span] = []  # open spans, innermost last
        self.clear()

    def clear(self) -> None:
        """Drop what was recorded; spans still open record on."""
        self.pending: List[_Span] = []  # closed outermost spans, not folded
        self.totals: Dict[str, List[float]] = {}  # [count, dev, self, host]
        self.parents: Dict[str, set] = {}
        self.trees = collections.deque(maxlen=TREES_KEPT)
        self.counters: Dict[str, Union[int, torch.Tensor]] = {}

    def fold(self, wait: bool) -> None:
        """Fold the closed trees whose device work has ended (with ``wait``,
        all of them, waiting for it) into the totals, oldest first."""
        while self.pending:
            root = self.pending[0]
            tree = _walk(root)
            if root.ev0 is not None:
                if wait:
                    root.ev1.synchronize()
                elif not all(s.ev1.query() for s in tree):
                    return
            self.pending.pop(0)
            at = {id(s): _interval(root, s) for s in tree}
            by_name: Dict[str, float] = {}
            for s in tree:
                a, b = at[id(s)]
                kids = [(max(a, at[id(c)][0]), min(b, at[id(c)][1]))
                        for c in s.children]
                t = self.totals.setdefault(s.name, [0, 0.0, 0.0, 0.0])
                t[0] += 1
                t[1] += b - a
                t[2] += b - a - _covered(kids)
                t[3] += (s.t1 - s.t0) / 1e6
                by_name[s.name] = by_name.get(s.name, 0.0) + b - a
                if s.parent is not None:
                    self.parents.setdefault(s.name, set()).add(s.parent.name)
            self.trees.append((root.name, by_name))


def _walk(span: _Span) -> List[_Span]:
    out = [span]
    for c in span.children:
        out += _walk(c)
    return out


def _interval(root: _Span, s: _Span) -> Tuple[float, float]:
    """``s``'s device interval in ms from ``root``'s start: CUDA events, or
    the host clock where the span has none."""
    if root.ev0 is None:
        return (s.t0 - root.t0) / 1e6, (s.t1 - root.t0) / 1e6
    a = 0.0 if s is root else root.ev0.elapsed_time(s.ev0)
    return a, root.ev0.elapsed_time(s.ev1)


def _covered(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of ``spans``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > max(a, end):
            total += b - max(a, end)
            end = b
    return total


_RECORD = _Record()


def annotate(name: str):
    """A named span of the program (a context manager): a
    ``record_function`` range and a recorded span while a ``torch.profiler``
    runs, nothing otherwise (module notes)."""
    return _Span(name) if recording() else _OFF


def annotate_backward(name: str, out: torch.Tensor, inp: torch.Tensor) -> None:
    """While a profiler runs, a span ``name`` over the backward from
    ``out``'s gradient to ``inp``'s: a gradient hook on ``out`` opens it and
    one on ``inp`` closes it.  Nothing is registered otherwise, or where
    either tensor takes no gradient."""
    if not (out.requires_grad and inp.requires_grad and recording()):
        return
    span = _Span(name)

    def opened(_grad):
        span.open()

    def closed(_grad):
        span.close()

    out.register_hook(opened)
    inp.register_hook(closed)


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (a host int, or a 0-d device tensor that the caller does
    not change afterwards) to counter ``name`` while a profiler runs."""
    if not recording():
        return
    prev = _RECORD.counters.get(name)
    _RECORD.counters[name] = value if prev is None else prev + value


def span_totals() -> Dict[str, Dict[str, float]]:
    """``{name: {count, device_ms, self_device_ms, host_ms, parents}}`` of
    the spans closed since :func:`reset`; waits for their device work.  Self
    time is the span's device time less the part of it that its children
    cover; ``parents`` names the spans it opened inside."""
    _RECORD.fold(wait=True)
    return {k: dict(count=c, device_ms=d, self_device_ms=s, host_ms=h,
                    parents=sorted(_RECORD.parents.get(k, ())))
            for k, (c, d, s, h) in _RECORD.totals.items()}


def span_trees(root: str) -> List[Dict[str, float]]:
    """For each of the last ``TREES_KEPT`` outermost spans named ``root``,
    oldest first: ``{name: device_ms}`` of it and the spans inside it
    (summed by name); waits for their device work."""
    _RECORD.fold(wait=True)
    return [dict(t) for name, t in _RECORD.trees if name == root]


def counter_totals() -> Dict[str, float]:
    """``{name: total}`` of the counters since :func:`reset` (reads device
    counters back)."""
    return {k: v.item() if isinstance(v, torch.Tensor) else v
            for k, v in _RECORD.counters.items()}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _RECORD.clear()


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
