"""Comm-trace replay engine (the port's ``param_tpu/trace/replay.py``;
PARAM's ``commsTraceReplayBench``).

Dry-run statistics of a basic, PyTorch-ET, Kineto or execution trace
(the last through ``comms_from_et``), warm-up replays, blocking or
non-blocking timed replays with tensors reused by op signature,
``--auto-shrink`` (a trace of a larger world remapped onto this one), the
``equal`` rebalance of ragged all_to_allv splits, per-process-group
routing from the trace's metadata, per-collective latency statistics and a
per-op JSON details dump.

Every process is one rank and replays the whole trace on its own tensors;
an op of a group this rank is not in is skipped on it.  A blocking replay
waits for each op on the device (``complete_ops``).  Embedded compute ops
run through the backend: ``gemm`` through ``compute_fn`` (cuBLAS),
``emb_lookup`` through ``emb_lookup`` (K1 on the card).
"""

from __future__ import annotations

import json
import logging
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from param_tpu_torch.backend.base import Backend, CollectiveArgs, CommGroup
from param_tpu_torch.trace.comms_trace import (
    P2P_OPS,
    SKIP_OPS,
    CommsOp,
    comms_from_et,
    parse_trace,
    read_trace_file,
)
from param_tpu_torch.trace.execution_trace import ExecutionTrace
from param_tpu_torch.utils.bw import alg_bw, bus_bw_factor
from param_tpu_torch.utils.dtypes import dtype_from_name, dtype_size
from param_tpu_torch.utils.sizes import percentile

log = logging.getLogger(__name__)


@dataclass
class ReplayParams:
    trace_path: Optional[str] = None
    trace_type: str = "basic"  # basic | pytorch_et | kineto | et
    target_rank: int = 0  # rank whose stream to take from per-rank traces
    dry_run: bool = False
    num_replays: int = 1
    num_warmup_replays: int = 1
    blocking: bool = False
    auto_shrink: bool = False
    rebalance_policy: Optional[str] = None  # None | "equal"
    do_warmup: bool = True
    output_path: Optional[str] = None
    use_timestamp: bool = False


@dataclass
class OpRecord:
    op_id: int
    comms: str
    size_bytes: int
    lat_us: float
    marker: str = ""


class CommsReplay:
    def __init__(self, backend: Backend, params: ReplayParams):
        self.backend = backend
        self.params = params
        self.ops: List[CommsOp] = []
        self._tensor_cache: Dict = {}
        self._pg_cache: Dict = {}
        self.records: List[OpRecord] = []
        self.total_replay_s: float = 0.0

    # ---------------------------------------------------------------- loading
    def load(self, trace=None) -> None:
        """Read the trace (``trace`` itself when given) into ``ops``; an
        execution trace (``et``: the port's aten graph or the JAX package's
        jaxpr) gives its collective stream (:func:`comms_from_et`)."""
        if trace is None:
            trace = read_trace_file(self.params.trace_path)
        if self.params.trace_type == "et":
            self.ops = comms_from_et(ExecutionTrace(trace),
                                     self.backend.get_world_size())
        else:
            self.ops = parse_trace(trace, self.params.trace_type,
                                   target_rank=self.params.target_rank,
                                   total_ranks=self.backend.get_world_size())
        if self.params.auto_shrink:
            self._shrink_to_world()
        if self.params.rebalance_policy == "equal":
            self._rebalance_splits()
        self._setup_groups()

    def _shrink_to_world(self) -> None:
        """Rescale ops recorded on another world size onto this one
        (PARAM's prepComms auto-shrink).  A ragged op's split length is
        its recorded world."""
        world = self.backend.get_world_size()
        for op in self.ops:
            split_len = max(len(op.in_split or ()), len(op.out_split or ()))
            old = split_len or op.world_size or world
            if old == world:
                continue
            if op.comms in ("all_to_all", "all_to_all_single", "all_to_allv"):
                per_peer_in = max(1, op.in_msg_size // old)
                per_peer_out = max(1, op.out_msg_size // old)
                op.in_msg_size = per_peer_in * world
                op.out_msg_size = per_peer_out * world
                if op.in_split:
                    # shrink: truncate (keeps raggedness); grow: equal splits
                    # at the original per-peer size
                    op.in_split = (op.in_split[:world] if old > world
                                   else [per_peer_in] * world)
                    op.in_msg_size = sum(op.in_split)
                if op.out_split:
                    op.out_split = (op.out_split[:world] if old > world
                                    else [per_peer_out] * world)
                    op.out_msg_size = sum(op.out_split)
            elif op.comms in ("all_gather", "all_gather_base", "gather",
                              "reduce_scatter", "reduce_scatter_base",
                              "scatter"):
                per_rank = max(1, op.out_msg_size // old)
                op.out_msg_size = per_rank * world
            if op.group_ranks:
                op.group_ranks = [r for r in op.group_ranks if r < world]
            op.world_size = world

    def _rebalance_splits(self) -> None:
        """Equal ragged all_to_allv splits (PARAM's rebalanceSplit, policy
        'equal')."""
        world = self.backend.get_world_size()
        for op in self.ops:
            if op.comms == "all_to_allv" and op.in_split:
                total = sum(op.in_split)
                base, rem = divmod(total, world)
                op.in_split = [base + (1 if i < rem else 0)
                               for i in range(world)]
                op.out_split = list(op.in_split)
                op.in_msg_size = total
                op.out_msg_size = total

    def _setup_groups(self) -> None:
        """Make the process groups the trace names, in trace order (every
        rank makes the same ones)."""
        world = self.backend.get_world_size()
        for op in self.ops:
            if op.pg_id is None or op.pg_id in self._pg_cache:
                continue
            ranks = [r for r in (op.group_ranks or range(world)) if r < world]
            if not ranks:
                ranks = list(range(world))
            self._pg_cache[op.pg_id] = self.backend.new_group(
                ranks, pg_id=op.pg_id)

    def _group_for(self, op: CommsOp) -> CommGroup:
        # under auto-shrink everything routes to the default group: the
        # trace's groups were laid out for another world
        if self.params.auto_shrink:
            return self.backend.get_default_group()
        if op.pg_id is not None and op.pg_id in self._pg_cache:
            return self._pg_cache[op.pg_id]
        return self.backend.get_default_group()

    # ---------------------------------------------------------------- dry run
    def dry_run_stats(self) -> Dict:
        """Per-collective op counts and message sizes."""
        stats: Dict[str, Dict] = defaultdict(
            lambda: {"count": 0, "total_bytes": 0, "sizes": []})
        for op in self.ops:
            if op.comms:
                es = (dtype_size(dtype_from_name(op.dtype))
                      if op.comms not in SKIP_OPS else 4)
                nbytes = op.in_msg_size * es
                s = stats[op.comms]
                s["count"] += 1
                s["total_bytes"] += nbytes
                s["sizes"].append(nbytes)
            elif op.compute:
                stats[f"compute:{op.compute}"]["count"] += 1
        return dict(stats)

    # ------------------------------------------------------------------ prep
    def prep_op(self, op: CommsOp) -> CollectiveArgs:
        """This rank's (cached) input for one trace op: ``in_msg_size``
        elements (the per-rank count), rounded up to a multiple of the group
        size for the collectives that split their input."""
        key = op.signature()
        if key in self._tensor_cache:
            return self._tensor_cache[key]
        g = self._group_for(op)
        n = g.size
        dtype = dtype_from_name(op.dtype)
        elems = max(1, op.in_msg_size)
        if op.comms in ("all_to_all", "all_to_all_single", "all_to_allv",
                        "reduce_scatter", "reduce_scatter_base", "scatter"):
            elems = max(n, -(-elems // n) * n)
        gen = torch.Generator().manual_seed(0)
        x = torch.rand(elems, generator=gen).to(self.backend.get_device()) \
            .to(dtype)
        args = CollectiveArgs(
            group=g, in_tensor=x, red_op="sum",
            src_rank=(op.root if op.comms in ("broadcast", "scatter",
                                              "multicast") else op.src_rank),
            dst_rank=(op.root if op.comms in ("reduce", "gather", "incast")
                      else op.dst_rank),
            in_split=op.in_split, out_split=op.out_split)
        if op.comms == "pt2pt" or op.comms in P2P_OPS:
            args.src_ranks = [op.src_rank]
            args.dst_ranks = [op.dst_rank]
        self._tensor_cache[key] = args
        return args

    def run_compute(self, op: CommsOp):
        """Replay an embedded compute op (PARAM's prepComputeReplay)."""
        dev = self.backend.get_device()
        if op.compute == "gemm":
            m, k, _, nn = op.mm_dims
            key = ("gemm", tuple(op.mm_dims), op.dtype)
            if key not in self._tensor_cache:
                dtype = dtype_from_name(op.dtype)
                self._tensor_cache[key] = (
                    torch.ones((m, k), dtype=dtype, device=dev),
                    torch.ones((k, nn), dtype=dtype, device=dev))
            a, b = self._tensor_cache[key]
            return self.backend.compute_fn["gemm"](a, b)
        if op.compute == "emb_lookup":
            key = ("emb", op.num_embs, op.emb_dim, op.batch_size, op.bag_size)
            if key not in self._tensor_cache:
                rng = np.random.default_rng(0)
                rows = max(op.num_embs, 1)
                table = torch.from_numpy(rng.random(
                    (rows, max(op.emb_dim, 1)), dtype=np.float32)).to(dev)
                idx = torch.from_numpy(rng.integers(
                    0, rows, size=(max(op.batch_size, 1),
                                   max(op.bag_size, 1))).astype(np.int32)) \
                    .to(dev)
                self._tensor_cache[key] = (table, idx)
            table, idx = self._tensor_cache[key]
            return self.backend.emb_lookup(table, idx)
        raise ValueError(f"unsupported compute {op.compute!r}")

    def _in_group(self, g: CommGroup) -> bool:
        return self.backend.get_global_rank() in g.ranks

    # ---------------------------------------------------------------- replay
    def replay_once(self, record: bool = True) -> float:
        """One pass over the trace (PARAM's replayTrace); wall seconds."""
        p = self.params
        backend = self.backend
        t_start = time.perf_counter()
        base_ts = None
        for op in self.ops:
            if op.comms in SKIP_OPS:
                if op.comms == "wait":
                    backend.complete_ops()
                elif op.comms == "barrier":
                    backend.barrier()
                continue
            if p.use_timestamp and op.start_time_ns is not None:
                # pace the ops as the trace's timestamps do
                if base_ts is None:
                    base_ts = (op.start_time_ns, time.perf_counter())
                else:
                    target = (op.start_time_ns - base_ts[0]) / 1e9
                    while time.perf_counter() - base_ts[1] < target:
                        pass
            t0 = time.perf_counter()
            if op.compute:
                self.run_compute(op)
                if p.blocking:
                    backend.complete_ops()
            else:
                name = "pt2pt" if op.comms in P2P_OPS else op.comms
                fn = backend.collective_fn.get(name)
                if fn is None:
                    log.warning("skipping unsupported collective %s", name)
                    continue
                args = self.prep_op(op)
                if not self._in_group(args.group):
                    continue
                fn(args)
                if p.blocking:
                    backend.complete_ops()
            lat_us = (time.perf_counter() - t0) * 1e6
            if record:
                es = dtype_size(dtype_from_name(op.dtype))
                self.records.append(OpRecord(
                    op_id=op.id, comms=op.comms or f"compute:{op.compute}",
                    size_bytes=op.in_msg_size * es if op.comms else 0,
                    lat_us=lat_us, marker="/".join(op.markers)))
        backend.complete_ops()
        return time.perf_counter() - t_start

    def run(self, trace: Optional[List[dict]] = None) -> Dict:
        """Load (unless loaded), then a dry run or the warm-up and timed
        replays; returns the report."""
        p = self.params
        if not self.ops:
            self.load(trace)
        if p.dry_run:
            return {"dry_run": self.dry_run_stats()}
        if p.do_warmup:
            for _ in range(p.num_warmup_replays):
                self.replay_once(record=False)
        self.records.clear()
        total = 0.0
        for _ in range(p.num_replays):
            total += self.replay_once(record=True)
        self.total_replay_s = total
        return self.report()

    # ---------------------------------------------------------------- report
    def report(self) -> Dict:
        per_coll: Dict[str, List[OpRecord]] = defaultdict(list)
        for r in self.records:
            per_coll[r.comms].append(r)
        world = self.backend.get_world_size()
        out = {
            "total_replay_s": self.total_replay_s,
            "num_replays": self.params.num_replays,
            "num_ops": len(self.ops),
            "collectives": {},
        }
        for name, recs in per_coll.items():
            lats = [r.lat_us for r in recs]
            sizes = [r.size_bytes for r in recs]
            p50 = percentile(lats, 50)
            entry = {
                "count": len(recs),
                "total_bytes": sum(sizes),
                "p50_us": p50,
                "p95_us": percentile(lats, 95),
                "max_us": max(lats),
            }
            if self.params.blocking and sizes and p50:
                entry["alg_bw_gbs"] = alg_bw(int(percentile(sizes, 50)), p50)
                entry["bus_bw_gbs"] = entry["alg_bw_gbs"] * bus_bw_factor(
                    name, world)
            out["collectives"][name] = entry
        if self.params.output_path:
            self.write_details(self.details_path())
        return out

    def details_path(self) -> str:
        """``output_path`` on rank 0, ``output_path.rank<r>`` on rank r."""
        r = self.backend.get_global_rank()
        return (self.params.output_path if r == 0
                else f"{self.params.output_path}.rank{r}")

    def write_details(self, path: str) -> None:
        """Per-op replay dump (PARAM's writeCommDetails)."""
        with open(path, "w") as f:
            json.dump([{"id": r.op_id, "comms": r.comms,
                        "size_bytes": r.size_bytes, "lat_us": r.lat_us,
                        "marker": r.marker} for r in self.records], f,
                      indent=2)
