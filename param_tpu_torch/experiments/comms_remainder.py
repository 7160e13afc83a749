"""Checks of the comms remainder and the comm-trace replay over a world of
ranks, one process a rank (torchrun; one card each on NCCL, or gloo with
``--device cpu``).  Rank 0 prints one JSON line; any failed check exits 1.

- quantized collectives: the sum all_reduce at bitwidth 8 and 16 of each
  rank's random f32 input against the f32 all_reduce of the same inputs,
  ``max |got - want| <= rtol * max |want|`` with rtol 0.02 at 8 bits and
  1e-2 at 16 (the reference's tests' tolerances); the rooted reduce too,
  zeros off the root;
- the overlap bench: same-group ``all_reduce`` with ``all_gather``, and
  split-pgs when the world is even and at least 4, every time finite and
  the efficiency in [0, 1];
- the comms-compute bench with ``gemm``;
- a sweep recorded through the backend's dispatch table and replayed
  blocking on the same world: the replayed ops, their count and their
  sizes equal the recorded ones.

    torchrun --standalone --nproc-per-node 4 \\
        -m param_tpu_torch.experiments.comms_remainder
    torchrun --standalone --nproc-per-node 4 \\
        -m param_tpu_torch.experiments.comms_remainder -- --device cpu --small
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from param_tpu_torch.backend import CollectiveArgs, DistBackend
from param_tpu_torch.comms.coll_bench import CollBench
from param_tpu_torch.comms.harness import CommsParams
from param_tpu_torch.comms.overlap_bench import CommsComputeBench, OverlapBench
from param_tpu_torch.trace.replay import CommsReplay, ReplayParams
from param_tpu_torch.utils.dtypes import dtype_from_name, dtype_size

RTOL = {8: 0.02, 16: 1e-2}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_quantized(backend, elems: int) -> dict:
    me, dev = backend.get_global_rank(), backend.get_device()
    gen = torch.Generator(device=dev).manual_seed(1000 + me)
    x = torch.randn(elems, generator=gen, device=dev)
    want = backend.all_reduce(CollectiveArgs(in_tensor=x))
    want_reduce = backend.reduce(CollectiveArgs(in_tensor=x))
    out = {}
    for bw in (8, 16):
        got = backend.all_reduce(CollectiveArgs(in_tensor=x, bitwidth=bw))
        red = backend.reduce(CollectiveArgs(in_tensor=x, bitwidth=bw))
        err = _rel_err(got, want)
        red_err = (_rel_err(red, want_reduce) if me == 0
                   else red.abs().max().item())
        out[bw] = dict(rel_err=err, reduce_rel_err=red_err, rtol=RTOL[bw],
                       ok=err <= RTOL[bw] and red_err <= RTOL[bw]
                       and (me == 0 or red_err == 0.0))
    return out


def check_overlap(backend, size: int, chain: int) -> dict:
    ob = OverlapBench(backend)
    out = {}
    r = ob.run_same_group("all_reduce", ["all_gather"], size, n_hi=chain)
    out["same_group"] = dict(solo_us=list(r.solo_us), t_both_us=r.t_both_us,
                             eff=r.overlap_efficiency)
    n = backend.get_world_size()
    if n >= 4 and n % 2 == 0:
        r = ob.run_split_pgs("all_reduce", size, n_hi=chain)
        out["split_pgs"] = dict(solo_us=list(r.solo_us),
                                t_both_us=r.t_both_us,
                                eff=r.overlap_efficiency)
    for rec in out.values():
        times = rec["solo_us"] + [rec["t_both_us"]]
        rec["ok"] = (all(math.isfinite(t) and t > 0 for t in times)
                     and 0.0 <= rec["eff"] <= 1.0)
    return out


def check_comms_compute(backend, size: int, mm_dim: int, chain: int) -> dict:
    r = CommsComputeBench(backend).run("all_reduce", size, "gemm",
                                       mm_dim=mm_dim, n_hi=chain)
    r["ok"] = all(math.isfinite(r[k]) and r[k] > 0 for k in
                  ("t_comm_us", "t_compute_us", "t_both_us")) and \
        0.0 <= r["overlap_efficiency"] <= 1.0
    return r


def check_replay(backend, end: int) -> dict:
    """Record a sweep of all_reduce and all_to_all through the dispatch
    table, replay it blocking, and compare op for op."""
    params = CommsParams(collectives=["all_reduce", "all_to_all"],
                         begin_size=1024, end_size=end, step_factor=8,
                         num_iters=2, num_warmup_iters=1)
    backend.start_trace_recording()
    try:
        CollBench(backend, params, reps=1).run()
    finally:
        trace = backend.stop_trace_recording()
    rp = CommsReplay(backend, ReplayParams(blocking=True, do_warmup=False))
    rp.run(trace)
    recorded = [(e["comms"], e["in_msg_size"]
                 * dtype_size(dtype_from_name(e["dtype"]))) for e in trace]
    replayed = [(r.comms, r.size_bytes) for r in rp.records]
    return dict(recorded=len(recorded), replayed=len(replayed),
                ok=recorded == replayed and len(recorded) > 0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:  # what torchrun passes on after ``-m ... --``
        argv = argv[1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="small sizes (a CPU rehearsal)")
    ns = ap.parse_args(argv)
    backend = DistBackend(ns.device)
    backend.initialize()
    try:
        small = ns.small
        res = {
            "world": backend.get_world_size(),
            "device": str(backend.get_device()),
            "quantized": check_quantized(backend,
                                         4099 if small else (4 << 20) + 3),
            "overlap": check_overlap(backend, 64 << 10 if small else 4 << 20,
                                     2 if small else 16),
            "comms_compute": check_comms_compute(
                backend, 64 << 10 if small else 1 << 20,
                64 if small else 1024, 2 if small else 16),
            "replay": check_replay(backend, 16 << 10 if small else 16 << 20),
        }
        oks = [res["replay"]["ok"], res["comms_compute"]["ok"]]
        oks += [v["ok"] for v in res["quantized"].values()]
        oks += [v["ok"] for v in res["overlap"].values()]
        flag = torch.tensor([float(all(oks))], device=backend.get_device())
        agreed = backend.all_reduce(CollectiveArgs(in_tensor=flag,
                                                   red_op="min"))
        res["ok"] = bool(agreed.item() > 0.5)
        if backend.get_global_rank() == 0:
            print(json.dumps(res), flush=True)
    finally:
        backend.shutdown()
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
