"""Device-trace (chrome trace) post-analysis of ``torch.profiler`` traces
(the port's ``param_tpu/trace/device_trace.py``; PARAM reads Kineto JSON
in ``et_replay/comm/profiler_trace_analysis.py``).

``--profile DIR`` writes ``DIR/trace.json`` (``export_chrome_trace``).
This module reads it into per-kernel device-time histograms, named-region
(``record_function``) durations and collective timings, and splits a
quantized collective's device time into comm, quant, dequant and other:

- comm: NCCL kernels (their names start ``nccl``), and any device work
  launched inside a collective's host op (``c10d::...`` or ``nccl:...``;
  a collective of one rank is a copy);
- quant / dequant: a kernel that lies inside the GPU-side span of a
  ``record_function("quantize")`` / ``("dequantize")`` region (Kineto's
  ``gpu_user_annotation`` events, on the stream's own lane) or, in a trace
  without those spans, whose launch (the ``cuda_runtime`` event of the same
  ``correlation`` id) lies inside the CPU-side region
  (``user_annotation``);
- other: every other kernel, copy and memset.

:func:`span_idle` gives the device's view of the program's spans
(``utils.profiler.annotate``): the busy and idle time inside each span's
device extent and the longest idle gaps there, each named by its span and
by the host op launched after it.

Run:
    python -m param_tpu_torch.cli.comms --bitwidth 8 --profile prof ...
    python -m param_tpu_torch.trace.device_trace prof --top 20
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# device work in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# NCCL kernel name fragments -> collective (the reduce-scatter before
# reduce, which its name contains)
COLLECTIVE_MARKERS = (
    ("allreduce", "all_reduce"), ("allgather", "all_gather"),
    ("reducescatter", "reduce_scatter"), ("alltoall", "all_to_all"),
    ("sendrecv", "pt2pt"), ("broadcast", "broadcast"), ("reduce", "reduce"),
)


def find_trace_file(path: str) -> str:
    """A profile dir (``trace.json`` or ``*.json[.gz]`` under it) or a
    trace file."""
    if os.path.isfile(path):
        return path
    cands = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                             recursive=True)
                   + glob.glob(os.path.join(path, "**", "*.json.gz"),
                               recursive=True))
    if not cands:
        raise FileNotFoundError(f"no *.json / *.json.gz trace under {path}")
    return cands[-1]


def load_chrome_trace(path: str) -> Tuple[List[dict], Dict[tuple, str]]:
    """-> (complete events, (pid, tid) -> "process/thread" name)."""
    f = find_trace_file(path)
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt") as fh:
        data = json.load(fh)
    events = data.get("traceEvents", [])
    threads: Dict[tuple, str] = {}
    procs: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                procs[e.get("pid")] = e.get("args", {}).get("name", "")
            elif e.get("name") == "thread_name":
                threads[(e.get("pid"), e.get("tid"))] = \
                    e.get("args", {}).get("name", "")
    qualified = {k: f"{procs.get(k[0], '')}/{v}" for k, v in threads.items()}
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    return xs, qualified


def _device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def op_durations(events: List[dict], threads: Dict[tuple, str],
                 thread_filter: Optional[str] = None,
                 include_python: bool = False) -> Dict[str, Dict]:
    """Durations by event name; ``thread_filter``: a substring of the
    qualified thread name.  Python-frame events are dropped unless
    ``include_python``."""
    agg: Dict[str, Dict] = defaultdict(lambda: {"count": 0, "total_us": 0.0})
    for e in events:
        name = e.get("name", "")
        if not include_python and e.get("cat") == "python_function":
            continue
        tname = threads.get((e.get("pid"), e.get("tid")), "")
        if thread_filter and thread_filter not in tname:
            continue
        a = agg[name]
        a["count"] += 1
        a["total_us"] += float(e["dur"])
    return dict(agg)


def region_durations(events: List[dict], names: List[str]) -> Dict[str, Dict]:
    """Host durations of named ``record_function`` regions."""
    out: Dict[str, Dict] = {}
    for name in names:
        durs = [float(e["dur"]) for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation"]
        if durs:
            out[name] = {"count": len(durs), "total_us": sum(durs),
                         "mean_us": sum(durs) / len(durs)}
    return out


def _collective_of(name: str) -> Optional[str]:
    low = name.lower()
    if not low.startswith("nccl"):
        return None
    flat = low.replace("_", "")
    for marker, coll in COLLECTIVE_MARKERS:
        if marker in flat:
            return coll
    return "nccl"


def collective_durations(events: List[dict],
                         threads: Dict[tuple, str]) -> Dict[str, Dict]:
    """Device time by collective, from the NCCL kernels' names."""
    agg: Dict[str, Dict] = defaultdict(lambda: {"count": 0, "total_us": 0.0})
    for e in _device_events(events):
        coll = _collective_of(e.get("name", ""))
        if coll is not None:
            agg[coll]["count"] += 1
            agg[coll]["total_us"] += float(e["dur"])
    return dict(agg)


def collective_bus_bw(coll_durs: Dict[str, Dict], size_bytes: int,
                      world: int) -> Dict[str, float]:
    """busBW per collective, given the payload of one call."""
    from param_tpu_torch.utils.bw import alg_bw, bus_bw_factor

    out = {}
    for coll, d in coll_durs.items():
        if d["count"]:
            per_us = d["total_us"] / d["count"]
            out[coll] = alg_bw(size_bytes, per_us) * bus_bw_factor(coll,
                                                                   world)
    return out


class _Spans:
    """Spans of one lane, merged where they overlap, for containment
    queries."""

    def __init__(self, spans):
        merged = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.spans = merged
        self.starts = [s for s, _ in merged]

    def holds(self, t0: float, t1: float) -> bool:
        i = bisect.bisect_right(self.starts, t0) - 1
        return i >= 0 and self.spans[i][1] >= t1


def _busy_in(lane: _Spans, t0: float, t1: float
             ) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy time, idle gaps) of ``lane``'s merged spans within [t0, t1]."""
    i = max(bisect.bisect_right(lane.starts, t0) - 1, 0)
    busy, gaps, t = 0.0, [], t0
    for s, e in lane.spans[i:]:
        if s >= t1:
            break
        if e <= t:
            continue
        if s > t:
            gaps.append((t, s))
        busy += min(e, t1) - max(s, t)
        t = e
    if t < t1:
        gaps.append((t, t1))
    return busy, gaps


def _launches(events: List[dict]) -> Dict[int, dict]:
    """{correlation id: the host's launch event} of a trace."""
    return {e["args"]["correlation"]: e for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}


def _innermost(ops: List[dict], t: float) -> Optional[dict]:
    """The latest-opened of ``ops`` open at time ``t``."""
    held = [e for e in ops if float(e["ts"]) <= t
            <= float(e["ts"]) + float(e["dur"])]
    return max(held, key=lambda e: (float(e["ts"]), -float(e["dur"])),
               default=None)


def span_idle(events: List[dict], prefix: str = "dlrm.",
              top: int = 10) -> Dict:
    """The device's view of the spans named ``prefix``...: for each name,
    its device extents (count, total us), the busy time in them (the union
    of the device operations there) and the idle rest; ``busy_us``, the
    union of every device operation of the trace (kernels that overlap
    count once); and the ``top`` longest idle gaps inside the spans, each
    named by the innermost span that holds it and by the host op that
    launched the operation after it.

    A span's extent runs from the start of the first to the end of the last
    device operation launched, from any thread of its process, while its
    host range (``user_annotation``) was open.  Kineto's own
    ``gpu_user_annotation`` extent holds only the launches of the range's
    own thread outside inner ranges: the backward's kernels launch from
    autograd's device thread, and a range whose kernels all lie in inner
    ranges (``dlrm.step``) gets none."""
    dev = sorted(_device_events(events), key=lambda e: float(e["ts"]))
    launches = _launches(events)
    launched = defaultdict(list)  # host pid -> [(launch ts, device op)]
    for e in dev:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            launched[launch.get("pid")].append((float(launch["ts"]), e))
    for v in launched.values():
        v.sort(key=lambda x: x[0])
    keys = {pid: [t for t, _ in v] for pid, v in launched.items()}
    extents = []  # (device pid, start, end, name)
    for r in events:
        if r.get("cat") != "user_annotation" or \
                not r.get("name", "").startswith(prefix) or \
                r.get("pid") not in launched:
            continue
        t0, t1 = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        ks = keys[r.get("pid")]
        mine = [e for _, e in launched[r.get("pid")][
            bisect.bisect_left(ks, t0):bisect.bisect_right(ks, t1)]]
        if mine:
            extents.append((mine[0].get("pid"),
                            min(float(e["ts"]) for e in mine),
                            max(float(e["ts"]) + float(e["dur"]) for e in mine),
                            r["name"]))
    ops_of = defaultdict(list)
    for e in dev:
        ops_of[e.get("pid")].append(e)
    starts = {pid: [float(e["ts"]) for e in ops]
              for pid, ops in ops_of.items()}
    lanes = {pid: _Spans([(t, t + float(e["dur"]))
                          for t, e in zip(starts[pid], ops)])
             for pid, ops in ops_of.items()}
    spans: Dict[str, Dict] = {}
    for pid, t0, t1, name in extents:
        d = spans.setdefault(name, {"count": 0, "extent_us": 0.0,
                                    "busy_us": 0.0})
        d["count"] += 1
        d["extent_us"] += t1 - t0
        d["busy_us"] += _busy_in(lanes[pid], t0, t1)[0]
    for d in spans.values():
        d["idle_us"] = d["extent_us"] - d["busy_us"]
    gaps = []
    for pid in {x[0] for x in extents}:
        mine = [x for x in extents if x[0] == pid]
        for r0, r1 in _Spans([(t0, t1) for _, t0, t1, _ in mine]).spans:
            for g0, g1 in _busy_in(lanes[pid], r0, r1)[1]:
                inner = min((x for x in mine if x[1] <= g0 and x[2] >= g1),
                            key=lambda x: x[2] - x[1], default=None)
                gaps.append((g1 - g0, pid, g1, inner[3] if inner else ""))
    gaps.sort(key=lambda g: -g[0])
    host = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            host[(e.get("pid"), e.get("tid"))].append(e)
    named = []
    for us, pid, g1, span in gaps[:top]:
        nxt = ops_of[pid][bisect.bisect_left(starts[pid], g1)]
        launch = launches.get(nxt.get("args", {}).get("correlation"))
        op = launch and _innermost(host[(launch.get("pid"), launch.get("tid"))],
                                   float(launch["ts"]))
        named.append({"us": us, "span": span,
                      "before": op["name"] if op else nxt["name"]})
    busy_us = sum(e - s for lane in lanes.values() for s, e in lane.spans)
    return {"busy_us": busy_us, "device_ops": len(dev), "spans": spans,
            "gaps": named}


def _lanes(events, keep) -> Dict[tuple, _Spans]:
    """{(pid, tid): _Spans} of the events ``keep`` selects."""
    lanes = defaultdict(list)
    for e in events:
        if keep(e):
            ts = float(e["ts"])
            lanes[(e.get("pid"), e.get("tid"))].append(
                (ts, ts + float(e["dur"])))
    return {lane: _Spans(v) for lane, v in lanes.items()}


def _is_comm_op(name: str) -> bool:
    """A host op of a collective: the c10d op or ProcessGroupNCCL's
    ``nccl:`` region."""
    return name.startswith(("c10d::", "nccl:"))


def quant_comm_split(events: List[dict],
                     threads: Optional[Dict[tuple, str]] = None,
                     thread_filter: Optional[str] = None) -> Dict[str, Dict]:
    """Device time of a quantized collective's trace in four buckets (see
    the module docstring): comm (NCCL kernels, and the copies a collective
    of one rank makes, launched inside its host op), quant, dequant and
    other."""
    out = {k: {"count": 0, "total_us": 0.0}
           for k in ("comm", "quant", "dequant", "other")}
    threads = threads or {}
    gpu = {r: _lanes(events, lambda e, r=r: e.get("cat") ==
                     "gpu_user_annotation" and e.get("name") == r)
           for r in ("quantize", "dequantize")}
    cpu = {r: _lanes(events, lambda e, r=r: e.get("cat") ==
                     "user_annotation" and e.get("name") == r)
           for r in ("quantize", "dequantize")}
    cpu["comm"] = _lanes(events, lambda e: e.get("cat") in (
        "cpu_op", "user_annotation") and _is_comm_op(e.get("name", "")))
    launches = _launches(events)

    def inside(region, e) -> bool:
        if region in gpu:
            t0 = float(e["ts"])
            lane = gpu[region].get((e.get("pid"), e.get("tid")))
            if lane is not None and lane.holds(t0, t0 + float(e["dur"])):
                return True
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            return False
        lane = cpu[region].get((launch.get("pid"), launch.get("tid")))
        lt = float(launch["ts"])
        return lane is not None and lane.holds(lt, lt)

    for e in _device_events(events):
        tname = threads.get((e.get("pid"), e.get("tid")), "")
        if thread_filter and thread_filter not in tname:
            continue
        if _collective_of(e.get("name", "")) is not None or \
                inside("comm", e):
            bucket = "comm"
        elif inside("dequantize", e):
            bucket = "dequant"
        elif inside("quantize", e):
            bucket = "quant"
        else:
            bucket = "other"
        out[bucket]["count"] += 1
        out[bucket]["total_us"] += float(e.get("dur", 0))
    return out


def print_top_ops(agg: Dict[str, Dict], top: int = 20) -> None:
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total_us"])[:top]
    print(f"{'op':<60}{'count':>8}{'total(us)':>14}{'mean(us)':>12}")
    for name, d in rows:
        mean = d["total_us"] / max(1, d["count"])
        print(f"{name[:58]:<60}{d['count']:>8}{d['total_us']:>14.1f}"
              f"{mean:>12.1f}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="param_tpu_torch.device_trace")
    ap.add_argument("path", help="profile dir or trace.json(.gz)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--thread-filter", default=None,
                    help="only threads whose name contains this")
    ap.add_argument("--python", action="store_true",
                    help="include python-frame events")
    ns = ap.parse_args(argv)
    events, threads = load_chrome_trace(ns.path)
    print(f"{len(events)} events, {len(threads)} threads")
    print_top_ops(op_durations(_device_events(events) or events, threads,
                               ns.thread_filter, ns.python), ns.top)
    colls = collective_durations(events, threads)
    if colls:
        print("\ncollectives:")
        for name, d in sorted(colls.items()):
            print(f"  {name}: n={d['count']} total={d['total_us']:.1f}us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
