"""Reads a ``torch.profiler`` chrome trace into classified device operations.

Each device operation (kernel, copy, memset) is tied to the host op that
launched it through the profiler's correlation id (the ``cuda_runtime`` or
``cuda_driver`` launch event carries the kernel's id, and the host ops open
on that thread at the launch are its callers).  Its class:

- ``comm``: an NCCL kernel, by its name (a frozen copy of the rule of
  ``param_tpu_torch/trace/device_trace.py``: names that start ``nccl``);
- ``emb_lookup`` / ``row_update``: launched under the port's ops
  ``param_tpu_torch::emb_gather`` (K1) / ``param_tpu_torch::sparse_update``
  (K2);
- ``gemm``: a kernel launched under ``aten::mm``, ``aten::addmm`` or
  ``aten::bmm`` (cuBLAS);
- ``other``: everything else.

Each operation also carries the step that launched it: the harness wraps
every profiled step in a ``torch.profiler.record_function`` named
``port_bench.step.<i>``, and an operation belongs to the step whose call
was open when it was launched, from whichever thread.  The traced window
runs from the end of the last operation of the step before the traced
steps to the end of the last operation of the last traced step, so idle
time at either edge counts.  Busy time is the union of the operations'
intervals within it, not their sum: kernels on several streams overlap.
"""

from __future__ import annotations

import bisect
import json
import math
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
PORT_OPS = {"param_tpu_torch::emb_gather": "emb_lookup",
            "param_tpu_torch::sparse_update": "row_update"}
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm")
STEP_TAG = "port_bench.step."


class DeviceOp(NamedTuple):
    name: str
    cls: str
    start_us: float
    dur_us: float
    caller: str  # the innermost host op open at its launch, or ""
    step: int  # the step whose call launched it (``STEP_TAG``), or -1


def _step_of(steps: List[Tuple[float, float, int]], ts: float) -> int:
    """The step whose call was open on the host at time ``ts``, by any
    thread (the backward's kernels launch from autograd's own)."""
    i = bisect.bisect_right(steps, (ts, math.inf, 0)) - 1
    return steps[i][2] if i >= 0 and ts <= steps[i][1] else -1


def is_nccl(name: str) -> bool:
    return name.lower().startswith("nccl")


def _callers(host: List[dict], launches: Dict[int, Tuple[tuple, float]]
             ) -> Dict[int, List[str]]:
    """{correlation id: names of the host ops open at its launch, outermost
    first}, by a sweep over each thread's ops in time order."""
    by_lane = defaultdict(list)
    for e in host:
        by_lane[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    points = defaultdict(list)
    for corr, (lane, ts) in launches.items():
        points[lane].append((ts, corr))
    out = {}
    for lane, pts in points.items():
        ops = sorted(by_lane.get(lane, []), key=lambda o: (o[0], -o[1]))
        stack: List[tuple] = []
        k = 0
        for ts, corr in sorted(pts):
            while k < len(ops) and ops[k][0] <= ts:
                while stack and stack[-1][1] < ops[k][0]:
                    stack.pop()
                stack.append(ops[k])
                k += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = [o[2] for o in stack if o[0] <= ts <= o[1]]
    return out


def classify(name: str, callers: List[str], cat: str) -> str:
    """A device operation's class (module notes).  A kernel whose launch
    the trace lacks is placed by its name where it is one of the port's."""
    if is_nccl(name):
        return "comm"
    for c in callers:
        if c in PORT_OPS:
            return PORT_OPS[c]
    if not callers:
        for fragment, cls in (("emb_gather", "emb_lookup"),
                              ("sparse_update", "row_update")):
            if fragment in name:
                return cls
    if cat == "kernel" and any(c in GEMM_OPS for c in callers):
        return "gemm"
    return "other"


def device_ops(path: str) -> List[DeviceOp]:
    """The classified device operations of the trace at ``path``, in time
    order."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launches = {}
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    callers = _callers(host, launches)
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    int(e["name"][len(STEP_TAG):]))
                   for e in host if e["name"].startswith(STEP_TAG))
    out = []
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        stack = callers.get(corr, [])
        step = _step_of(steps, launches[corr][1]) if corr in launches else -1
        out.append(DeviceOp(e["name"], classify(e["name"], stack, e["cat"]),
                            float(e["ts"]), float(e["dur"]),
                            stack[-1] if stack else "", step))
    out.sort(key=lambda o: o.start_us)
    return out


def union(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """Disjoint, sorted [start, end] intervals covering ``spans``."""
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def length(intervals: List[List[float]]) -> float:
    return sum(e - s for s, e in intervals)


def minus(a: List[List[float]], b: List[List[float]]) -> float:
    """Length of the union ``a`` not covered by the union ``b``."""
    starts = [s for s, _ in b]
    left = 0.0
    for s, e in a:
        t = s
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while t < e and i < len(b):
            bs, be = b[i]
            if be <= t:
                i += 1
                continue
            if bs >= e:
                break
            if bs > t:
                left += bs - t
            t = max(t, be)
            i += 1
        if t < e:
            left += e - t
    return left


def summary(ops: List[DeviceOp], first: int, last: int,
            top: int = 10) -> dict:
    """What the readers take from one rank's trace of steps ``first`` to
    ``last``: the window (module notes), busy time in it, time by class,
    NCCL time not covered by compute, the device operations that took most
    time and the longest idle gaps, named by the host op that launched the
    operation after the gap.  Empty where the trace holds none of those
    steps."""
    mine = [o for o in ops if first <= o.step <= last]
    if not mine:
        return {}
    end = max(o.start_us + o.dur_us for o in mine)
    before = [o.start_us + o.dur_us for o in ops if o.step == first - 1]
    start = max(before) if before else min(o.start_us for o in mine)
    spans = [(max(o.start_us, start), min(o.start_us + o.dur_us, end))
             for o in ops]
    inside = [(sp, o) for sp, o in zip(spans, ops) if sp[0] < sp[1]]
    busy = union(sp for sp, _ in inside)
    by_cls: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for o in mine:
        by_cls[o.cls] += o.dur_us
        by_name[o.name[:160]] += o.dur_us
    comm = union(sp for sp, o in inside if o.cls == "comm")
    compute = union(sp for sp, o in inside if o.cls != "comm")
    gaps = []
    starts = [sp[0] for sp, _ in inside]
    for e0, (s1, _) in zip([start] + [e for _, e in busy[:-1]], busy):
        if s1 > e0:
            nxt = inside[bisect.bisect_left(starts, s1)][1]
            gaps.append((s1 - e0,
                         "idle before " + (nxt.caller or nxt.name)[:120]))
    gaps.sort(key=lambda g: -g[0])
    return {
        "window_us": end - start,
        "busy_us": length(busy),
        "class_us": dict(by_cls),
        "comm_exposed_us": minus(comm, compute) if comm else None,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [(name, us) for us, name in gaps[:top]],
    }
