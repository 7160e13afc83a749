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
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

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
