"""Collective sweep benchmark, nccl-tests style (the port's
``param_tpu/comms/coll_bench.py``; PARAM's ``commsCollBench``).

For each collective and size: prepare the rank-pattern input, optionally
check the output (dcheck), then time it.  ``dispatch`` and ``graph`` time
``--w`` untimed calls and then windows of ``--n`` calls with CUDA events
(``graph``: replayed from a CUDA graph captured once); the latency
percentiles are over at least 10 windows, each giving the mean time per
iteration.  ``blocking`` times every call to its completion on the host
clock.  On the CPU (gloo) ``graph`` is the same as ``dispatch`` and the
windows are timed on the host clock.  The dcheck call works on a copy of
the input; the timed calls of the reducing collectives and broadcast work
in place in the buffer ``prep_comm`` allocated, as PARAM times them.  The pt2pt tests time ping, ping-pong
and a window of uni- / bi-directional sends.  The COMMS-RES table prints on
each group's first rank.
"""

from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from param_tpu_torch.backend.base import OBJECT_COLLECTIVES, Backend, CommGroup
from param_tpu_torch.comms.harness import CommsBench, CommsParams, TimingMode
from param_tpu_torch.utils.bw import alg_bw
from param_tpu_torch.utils.logger import (
    CommsCollPerfMetrics,
    CommsPt2PtPerfMetrics,
    emit_metrics,
)
from param_tpu_torch.utils.sizes import format_size, percentile
from param_tpu_torch.utils.timer import time_samples

log = logging.getLogger(__name__)

_HEADER = (
    f"{'COMMS-RES':>12}{'size(B)':>12}{'count':>12}{'p50(us)':>10}"
    f"{'p75(us)':>10}{'p95(us)':>10}{'min(us)':>10}{'max(us)':>10}"
    f"{'algBW(GB/s)':>13}{'busBW(GB/s)':>13}"
)
_PT2PT_HEADER = (
    f"{'COMMS-RES':>12}{'size(B)':>12}{'ping(us)':>12}{'pingpong(us)':>14}"
    f"{'uniBW(GB/s)':>13}{'biBW(GB/s)':>13}"
)
_MIN_WINDOWS = 10


@dataclass
class CollResult:
    collective: str
    size_bytes: int
    num_elements: int
    lat_us: List[float] = field(default_factory=list)
    alg_bw_gbs: float = 0.0
    bus_bw_gbs: float = 0.0
    dcheck_ok: Optional[bool] = None

    def pct(self, p):
        return percentile(self.lat_us, p)


class CollBench(CommsBench):
    """Runs the sweep."""

    def __init__(self, backend: Backend, params: CommsParams, reps: int = 3):
        super().__init__(backend, params)
        self.reps = reps
        self.profiler = None  # optional SizeTriggeredProfiler

    def _windows_us(self, fn, iters: int, warmup: int,
                    graph: bool = False) -> List[float]:
        """Mean microseconds per call of ``fn`` in each of at least 10
        windows of ``iters`` calls, after ``warmup`` untimed calls."""
        dev = self.backend.get_device()
        ms = time_samples(fn, iters, dev, warmup=warmup,
                          reps=max(self.reps, _MIN_WINDOWS),
                          graph=graph and dev.type == "cuda")
        return [t * 1e3 for t in ms]

    def run_one(self, collective: str, size_bytes: int,
                group: CommGroup) -> CollResult:
        p = self.params
        args = self.prep_comm(collective, size_bytes, group)
        fn = self.backend.collective_fn[collective]
        res = CollResult(collective=collective, size_bytes=size_bytes,
                         num_elements=size_bytes // self.elem_size)
        if p.dcheck:
            out = fn(args)
            self.backend.complete_ops()
            res.dcheck_ok = self.dcheck(collective, args, out)
        args.in_place = True

        k = max(1, p.num_coll_per_iter)

        def call():
            # num_coll_per_iter posts per timed iteration; latency is per
            # iteration
            r = None
            for _ in range(k):
                r = fn(args)
            return r

        if p.mode == TimingMode.BLOCKING or collective in OBJECT_COLLECTIVES:
            # object collectives pickle on the host every call: timed per
            # call, as the reference does
            for _ in range(max(1, p.num_warmup_iters)):
                call()
            self.backend.complete_ops()
            for _ in range(p.num_iters):
                t0 = time.perf_counter()
                call()
                self.backend.complete_ops()
                res.lat_us.append((time.perf_counter() - t0) * 1e6)
        else:
            res.lat_us = self._windows_us(call, p.num_iters,
                                          p.num_warmup_iters,
                                          graph=p.mode == TimingMode.GRAPH)

        payload = self.payload_bytes(collective, size_bytes, group)
        res.alg_bw_gbs = alg_bw(payload, res.pct(50))
        res.bus_bw_gbs = self.backend.get_bus_bw(collective, res.alg_bw_gbs,
                                                 group)
        return res

    def bench_collective(self, collective: str,
                         group: CommGroup) -> List[CollResult]:
        results = []
        for size in self.sweep_sizes(collective, group):
            if self.profiler is not None:
                self.profiler.maybe_start(size)
            results.append(self.run_one(collective, size, group))
        return results

    # ---------------------------------------------------------------- pt2pt
    def bench_pt2pt(self, size_bytes: int, group: CommGroup):
        """Ping latency, ping-pong latency, uni- / bi-directional window
        bandwidth; with ``--c 1`` the ping's output is checked too."""
        p = self.params
        args = self.prep_comm("pt2pt", size_bytes, group)
        if not args.src_ranks:
            if p.pt2pt == "pairwise":
                half = group.size // 2
                args.src_ranks = list(range(half))
                args.dst_ranks = [r + half for r in range(half)]
            else:  # one2one
                args.src_ranks = [p.src_rank]
                args.dst_ranks = [p.dst_rank or (group.size - 1)]
        b = self.backend
        dcheck_ok = None
        if p.dcheck:
            out = b.send_recv(args)
            b.complete_ops()
            dcheck_ok = self.dcheck("pt2pt", args, out)

        def med(fn, iters, warmup):
            return statistics.median(self._windows_us(fn, iters, warmup))

        ping = med(lambda: b.ping(args, pong=False), p.num_iters,
                   p.num_warmup_iters)
        pingpong = med(lambda: b.ping(args, pong=True), p.num_iters,
                       p.num_warmup_iters)
        uni = med(lambda: b.window_send(args, p.window, bidirectional=False),
                  max(2, p.num_iters // 4), 1)
        bi = med(lambda: b.window_send(args, p.window, bidirectional=True),
                 max(2, p.num_iters // 4), 1)
        n_pairs = len(args.src_ranks)
        m = CommsPt2PtPerfMetrics(
            commsOp="pt2pt", dtype=p.dtype, world_size=group.size,
            tag=p.tag, input_size_bytes=size_bytes, ping_p50_us=ping,
            ping_pong_p50_us=pingpong,
            uni_bw_gbs=n_pairs * p.window * size_bytes / (uni * 1e3),
            bi_bw_gbs=2 * n_pairs * p.window * size_bytes / (bi * 1e3))
        return m, dcheck_ok

    # --------------------------------------------------------------- report
    def _reports(self, group: CommGroup) -> bool:
        return self.backend.get_global_rank() == group.ranks[0]

    def report(self, collective: str, results: List[CollResult],
               group: CommGroup):
        """Print the COMMS-RES table and emit metrics to registered loggers
        (on the group's first rank)."""
        if not self._reports(group):
            return
        print(f"\nCOMMS-RES: {collective} dtype={self.params.dtype} "
              f"world={group.size} mode={self.params.mode.value} "
              f"device={self.backend.get_device()}")
        print(_HEADER)
        for r in results:
            check = "" if r.dcheck_ok is None else (
                "  OK" if r.dcheck_ok else "  BAD")
            print(f"{format_size(r.size_bytes):>12}{r.size_bytes:>12}"
                  f"{r.num_elements:>12}{r.pct(50):>10.1f}{r.pct(75):>10.1f}"
                  f"{r.pct(95):>10.1f}{r.pct(0):>10.1f}{r.pct(100):>10.1f}"
                  f"{r.alg_bw_gbs:>13.2f}{r.bus_bw_gbs:>13.2f}{check}")
            emit_metrics(CommsCollPerfMetrics(
                commsOp=collective, dtype=self.params.dtype,
                world_size=group.size, tag=self.params.tag,
                input_size_bytes=r.size_bytes, output_size_bytes=r.size_bytes,
                num_elements=r.num_elements, p50_us=r.pct(50),
                p75_us=r.pct(75), p95_us=r.pct(95), min_us=r.pct(0),
                max_us=r.pct(100), alg_bw_gbs=r.alg_bw_gbs,
                bus_bw_gbs=r.bus_bw_gbs))

    def report_pt2pt(self, rows, group: CommGroup):
        if not self._reports(group):
            return
        print(f"\nCOMMS-RES: pt2pt dtype={self.params.dtype} "
              f"world={group.size} window={self.params.window} "
              f"device={self.backend.get_device()}")
        print(_PT2PT_HEADER)
        for m, ok in rows:
            check = "" if ok is None else ("  OK" if ok else "  BAD")
            print(f"{format_size(m.input_size_bytes):>12}"
                  f"{m.input_size_bytes:>12}{m.ping_p50_us:>12.1f}"
                  f"{m.ping_pong_p50_us:>14.1f}{m.uni_bw_gbs:>13.2f}"
                  f"{m.bi_bw_gbs:>13.2f}{check}")
            emit_metrics(m)

    # ------------------------------------------------------------------ run
    def run(self) -> Dict:
        """The full sweep: every collective over every group this rank is
        in.  A failing collective raises (a rank that carried on would
        leave the others waiting in its next collective)."""
        known = set(self.backend.collective_fn)
        bad = [c for c in self.params.collectives if c not in known]
        if bad:
            raise ValueError(f"unknown collective(s) {bad}; supported: "
                             f"{sorted(known)}")
        all_results = {}
        for g in self.make_groups():
            for collective in self.params.collectives:
                if collective == "pt2pt" or self.params.pt2pt:
                    rows = [self.bench_pt2pt(size, g)
                            for size in self.sweep_sizes("pt2pt", g)]
                    self.report_pt2pt(rows, g)
                    all_results[("pt2pt", g.pg_id)] = rows
                    continue
                results = self.bench_collective(collective, g)
                self.report(collective, results, g)
                all_results[(collective, g.pg_id)] = results
        return all_results
