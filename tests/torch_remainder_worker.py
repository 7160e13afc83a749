"""One rank of a gloo world for the comms-remainder and trace-replay tests
(``tests/test_torch_{quantization,overlap,torchcomms,trace_replay}.py``).

    python tests/torch_remainder_worker.py MODE STORE_FILE RANK WORLD OUT_DIR

MODE is ``quant``, ``overlap``, ``torchcomms`` or ``trace``.  The rank runs
that mode's cases through ``param_tpu_torch`` and saves what it got to
``OUT_DIR/rank<RANK>.pt``.  It imports torch, numpy and the port only (no
JAX), so the test process can import the case lists and inputs from here
and feed the JAX package the same data; :func:`run_worlds` spawns the
worlds for a test.
"""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 120


def run_worlds(mode, worlds, tmp_path_factory):
    """Run ``mode`` in a gloo world of each size in ``worlds``, one world
    after the other (fewer processes at once beside the other test
    files), each under its own timeout; -> {n: [rank 0's results, ...]}."""
    import pytest
    import torch

    dirs = {n: str(tmp_path_factory.mktemp(f"{mode}{n}")) for n in worlds}
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for n in worlds:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode,
             os.path.join(dirs[n], "store"), str(r), str(n), dirs[n]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"{mode} world of {n} did not finish in "
                        f"{WORLD_TIMEOUT_S} s")
        bad = [(r, p.returncode, log) for r, (p, log)
               in enumerate(zip(procs, logs)) if p.returncode != 0]
        assert not bad, f"{mode} world of {n}: ranks failed: {bad}"
    return {n: [torch.load(os.path.join(dirs[n], f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
            for n in worlds}


# ------------------------------------------------------------------ quant
# (name, collective, CollectiveArgs fields, local shape)
QUANT_CASES = [
    ("all_reduce_bw8", "all_reduce", {"bitwidth": 8}, (16,)),
    ("all_reduce_bw8_odd", "all_reduce", {"bitwidth": 8}, (7,)),
    ("all_reduce_bw8_2d", "all_reduce", {"bitwidth": 8}, (5, 3)),
    ("all_reduce_bw16", "all_reduce", {"bitwidth": 16}, (16,)),
    ("all_reduce_bw16_odd", "all_reduce", {"bitwidth": 16}, (7,)),
    ("all_reduce_bw8_max", "all_reduce", {"bitwidth": 8, "red_op": "max"},
     (9,)),
    ("all_reduce_bw16_avg", "all_reduce",
     {"bitwidth": 16, "red_op": "avg"}, (8,)),
    ("reduce_bw8_root1", "reduce", {"bitwidth": 8, "dst_rank": 1}, (16,)),
    ("reduce_bw8_odd_root0", "reduce", {"bitwidth": 8}, (7,)),
    ("reduce_bw16_root1", "reduce", {"bitwidth": 16, "dst_rank": 1}, (16,)),
    ("reduce_bw8_max_root0", "reduce", {"bitwidth": 8, "red_op": "max"},
     (9,)),
]
QUANT_HARNESS = ["all_reduce", "reduce", "all_to_all", "all_gather",
                 "reduce_scatter"]


def quant_inputs(name, n, shape):
    """Per-rank inputs: uniform in [0.5, 1.5), so no sum is near zero."""
    rng = np.random.default_rng(sum(map(ord, name)) * 7 + n)
    return [(rng.random(shape) + 0.5).astype(np.float32) for _ in range(n)]


def run_quant(backend, rank, world):
    import torch

    from param_tpu_torch.backend import CollectiveArgs
    from param_tpu_torch.comms.coll_bench import CollBench
    from param_tpu_torch.comms.harness import CommsParams

    res = {}
    for name, coll, kw, shape in QUANT_CASES:
        x = torch.from_numpy(quant_inputs(name, world, shape)[rank])
        before = x.clone()
        res[name] = backend.collective_fn[coll](
            CollectiveArgs(in_tensor=x, **kw))
        res[f"untouched:{name}"] = bool(torch.equal(x, before))
    for bw in (8, 16):
        bench = CollBench(backend, CommsParams(
            num_iters=2, num_warmup_iters=1, dcheck=True, bitwidth=bw),
            reps=1)
        g = backend.get_default_group()
        for coll in QUANT_HARNESS:
            r = bench.run_one(coll, 1024, g)
            res[f"harness:{coll}:{bw}"] = (r.dcheck_ok, r.quant_us,
                                           r.bus_bw_gbs, r.alg_bw_gbs)
    return res


# ---------------------------------------------------------------- overlap
OVERLAP_SIZE = 4096
OVERLAP_SET = ("all_reduce", ["all_gather", "reduce_scatter", "all_to_all"])
CHAIN_STEPS = 3
COMPUTE_KW = {
    "gemm": dict(mm_dim=32, num_compute=2),
    "emb_lookup": dict(emb_rows=1000, emb_dim=16, emb_batch=32, emb_nnz=4,
                       num_compute=2),
}


def run_overlap(backend, rank, world):
    from param_tpu_torch.comms.overlap_bench import (
        CommsComputeBench, OverlapBench,
    )

    res = {}
    ob = OverlapBench(backend)
    res["same_group"] = [c.run(CHAIN_STEPS) for c in
                         ob.same_group_chains(*OVERLAP_SET, OVERLAP_SIZE)]
    r = ob.run_same_group("all_reduce", "all_gather", OVERLAP_SIZE, n_hi=2)
    res["same_group_timed"] = (len(r.solo_us), r.overlap_efficiency)
    if world >= 4:
        single, both = ob.split_pgs_chains("all_reduce", OVERLAP_SIZE)
        res["split_pgs"] = [single.run(CHAIN_STEPS) if single else None,
                            both.run(CHAIN_STEPS)]
        r = ob.run_split_pgs("all_gather", OVERLAP_SIZE, n_hi=2)
        res["split_pgs_timed"] = len(r.solo_us)
    else:
        try:
            ob.split_pgs_chains("all_reduce", OVERLAP_SIZE)
        except ValueError as e:
            res["split_pgs_error"] = str(e)
    cb = CommsComputeBench(backend)
    for kernel, kw in COMPUTE_KW.items():
        chains = cb.chains("all_reduce", OVERLAP_SIZE, kernel, **kw)
        res[kernel] = {k: c.run(CHAIN_STEPS) for k, c in chains.items()}
    for kernel in ("d2h", "h2d"):
        res[f"run:{kernel}"] = sorted(cb.run("all_gather", OVERLAP_SIZE,
                                             kernel, n_hi=2))
    return res


# ------------------------------------------------------------- torchcomms
def facade_inputs(n, r, shape=(8,)):
    rng = np.random.default_rng(100 + r)
    return rng.integers(-9, 10, size=shape).astype(np.float32)


def run_torchcomms(backend_unused, rank, world):
    import torch

    from param_tpu_torch.backend import (
        CollectiveArgs, DistBackend, ReduceOp, TorchComm, TorchcommsBackend,
    )
    from param_tpu_torch.comms.harness import CommsBench, CommsParams

    tc = TorchcommsBackend("cpu")
    tc.initialize()
    plain = DistBackend("cpu")
    plain.initialize()
    comm = TorchComm(tc)
    x = torch.from_numpy(facade_inputs(world, rank))
    xn = torch.from_numpy(facade_inputs(world, rank, (2 * world,)))
    S = [[(i + j) % 3 + 1 for j in range(world)] for i in range(world)]
    xv = torch.from_numpy(facade_inputs(world, rank, (3 * world,)))
    pairs = ([0, world - 1], [world - 1, 0])
    res = {"facade": {}, "plain": {}}
    calls = {
        "all_reduce_sum": (lambda: comm.all_reduce(x.clone()).result(),
                           "all_reduce", dict(in_tensor=x)),
        "all_reduce_max": (lambda: comm.all_reduce(
            x.clone(), op=ReduceOp.MAX, async_op=True).result(),
            "all_reduce", dict(in_tensor=x, red_op="max")),
        "all_reduce_avg": (lambda: comm.all_reduce(
            x.clone(), op="AVG").result(), "all_reduce",
            dict(in_tensor=x, red_op="avg")),
        "reduce_root1": (lambda: comm.reduce(x.clone(), root=1).result(),
                         "reduce", dict(in_tensor=x, dst_rank=1)),
        "reduce_avg_root0": (lambda: comm.reduce(
            x.clone(), op=ReduceOp.AVG, async_op=True).result(), "reduce",
            dict(in_tensor=x, red_op="avg")),
        "all_gather": (lambda: comm.all_gather(x).result(), "all_gather",
                       dict(in_tensor=x)),
        "all_to_all": (lambda: comm.all_to_all(xn, async_op=True).result(),
                       "all_to_all", dict(in_tensor=xn)),
        "broadcast_root1": (lambda: comm.broadcast(x.clone(),
                                                   root=1).result(),
                            "broadcast", dict(in_tensor=x, src_rank=1)),
        "reduce_scatter_sum": (lambda: comm.reduce_scatter(xn).result(),
                               "reduce_scatter", dict(in_tensor=xn)),
        "reduce_scatter_max": (lambda: comm.reduce_scatter(
            xn, op=ReduceOp.MAX).result(), "reduce_scatter",
            dict(in_tensor=xn, red_op="max")),
        "reduce_scatter_v": (lambda: comm.reduce_scatter_v(
            xn, out_split=[1, 2, 1, 2][:world]).result(), "reduce_scatter_v",
            dict(in_tensor=xn, out_split=[1, 2, 1, 2][:world])),
        "gather_root1": (lambda: comm.gather(x, root=1).result(), "gather",
                         dict(in_tensor=x, dst_rank=1)),
        "scatter_root1": (lambda: comm.scatter(xn, root=1).result(),
                          "scatter", dict(in_tensor=xn, src_rank=1)),
        "all_gather_v": (lambda: comm.all_gather_v(
            x, [3, 8, 5, 1][:world]).result(), "all_gather_v",
            dict(in_tensor=x, in_split=[3, 8, 5, 1][:world])),
        "all_to_all_v": (lambda: comm.all_to_all_v(xv, S).result(),
                         "all_to_allv", dict(in_tensor=xv, in_split=S)),
        "send_recv": (lambda: comm.send_recv(x, *pairs).result().clone(),
                      "pt2pt", dict(in_tensor=x, src_ranks=pairs[0],
                                    dst_ranks=pairs[1])),
        "incast": (lambda: comm.incast(x, root=0).result(), "incast",
                   dict(in_tensor=x)),
        "multicast": (lambda: comm.multicast(x, root=1).result(),
                      "multicast", dict(in_tensor=x, src_rank=1)),
    }
    for name, (facade, coll, kw) in calls.items():
        res["facade"][name] = facade()
        res["plain"][name] = plain.collective_fn[coll](CollectiveArgs(**kw))
        if coll == "pt2pt":
            res["plain"][name] = res["plain"][name].clone()
    # the harness table of the facade backend against the plain backend's
    for coll in ("all_reduce", "reduce", "all_gather", "reduce_scatter",
                 "all_to_all", "broadcast", "all_to_allv"):
        kw = dict(in_tensor=xn, dst_rank=world - 1, src_rank=world - 1)
        res["facade"][f"table:{coll}"] = tc.collective_fn[coll](
            CollectiveArgs(**kw))
        res["plain"][f"table:{coll}"] = plain.collective_fn[coll](
            CollectiveArgs(**kw))
        res[f"input_kept:{coll}"] = bool(torch.equal(
            xn, torch.from_numpy(facade_inputs(world, rank, (2 * world,)))))
    for bw in (8, 16):
        q = torch.from_numpy(facade_inputs(world, rank, (5,)) + 20)
        res["facade"][f"quant:{bw}"] = tc.collective_fn["all_reduce"](
            CollectiveArgs(in_tensor=q, bitwidth=bw))
        res["plain"][f"quant:{bw}"] = plain.collective_fn["all_reduce"](
            CollectiveArgs(in_tensor=q, bitwidth=bw))
    sub = comm.split([0, 1], pg_id=5)
    if rank in (0, 1):
        res["split"] = sub.all_reduce(x.clone()).result()
        res["split_size"] = sub.size()
    res["objects"] = comm.all_gather_object({"rank": rank})
    res["object_list"] = comm.broadcast_object_list([f"from {rank}"], root=1)
    comm.barrier()
    # every collective of the sweep through the facade, dcheck on
    params = CommsParams(dcheck=True)
    params.in_split = [16 * (r % 2 + 1) for r in range(world)]
    params.out_split = params.in_split
    params.src_ranks = [0, 1]
    params.dst_ranks = [1, 0]
    bench = CommsBench(tc, params)
    g = tc.get_default_group()
    res["dchecks"] = {}
    for coll in ("all_reduce", "reduce", "all_gather", "all_gather_base",
                 "all_gather_v", "reduce_scatter", "reduce_scatter_base",
                 "reduce_scatter_v", "all_to_all", "all_to_all_single",
                 "all_to_allv", "broadcast", "gather", "scatter", "incast",
                 "multicast", "pt2pt", "all_gather_object",
                 "broadcast_object_list"):
        args = bench.prep_comm(coll, 1024, g)
        res["dchecks"][coll] = bench.dcheck(coll, args,
                                            tc.collective_fn[coll](args))
    # recording wraps the facade's table and gives it back on stop
    before = dict(tc.collective_fn)
    tc.start_trace_recording()
    tc.collective_fn["all_reduce"](CollectiveArgs(in_tensor=x))
    tc.collective_fn["all_gather"](CollectiveArgs(in_tensor=x))
    res["recorded"] = tc.stop_trace_recording()
    res["table_restored"] = all(tc.collective_fn[k] is v
                                for k, v in before.items())
    return res


# ------------------------------------------------------------------ trace
BASIC_TRACE = [
    {"comms": "all_reduce", "in_msg_size": 1024, "out_msg_size": 1024,
     "dtype": "float32"},
    {"comms": "alltoall", "in_msg_size": 512, "out_msg_size": 512,
     "dtype": "float32"},
    {"comms": "wait"},
    {"comms": "broadcast", "in_msg_size": 256, "out_msg_size": 256,
     "dtype": "float32", "root": 1},
    {"comms": "all_gather", "in_msg_size": 64, "out_msg_size": 256,
     "dtype": "bfloat16"},
    {"compute": "gemm", "mm_dim": 16, "dtype": "float32"},
    {"compute": "emb_lookup", "emb_dim": 16, "num_embs": 100,
     "batch_size": 8, "bag_size": 4},
    {"comms": "barrier"},
]


def shrink_trace(world):
    """A trace recorded on a world of 8 (auto-shrink, rebalance)."""
    return [
        {"comms": "all_to_all", "in_msg_size": 8 * 64, "out_msg_size": 8 * 64,
         "dtype": "float32", "world_size": 8},
        {"comms": "all_gather", "in_msg_size": 16, "out_msg_size": 8 * 16,
         "dtype": "float32", "world_size": 8},
        {"comms": "all_to_allv", "in_msg_size": 80, "out_msg_size": 80,
         "dtype": "float32", "in_split": [76, 1, 1, 1, 1, 0, 0, 0],
         "out_split": [76, 1, 1, 1, 1, 0, 0, 0]},
    ]


def record_calls(world):
    """(collective, CollectiveArgs fields, local shape) the recording
    session makes, in order; rank r's input is filled with r + 1."""
    return [
        ("all_reduce", {}, (128,)),
        ("all_gather", {}, (16,)),
        ("reduce_scatter", {}, (16 * world,)),
        ("incast", {"dst_rank": 0, "src_ranks": [1]}, (32,)),
        ("pt2pt", {"src_ranks": [0], "dst_ranks": [world - 1]}, (8,)),
        ("all_to_allv", {"in_split": [2] * world}, (2 * world,)),
        ("broadcast", {"src_rank": 1}, (64,)),
        ("reduce", {"dst_rank": 1}, (64,)),
    ]


def run_trace(backend, rank, world, out_dir):
    import json

    import torch

    from param_tpu_torch.backend import CollectiveArgs
    from param_tpu_torch.cli import comms as comms_cli
    from param_tpu_torch.cli import replay as replay_cli
    from param_tpu_torch.trace.comms_trace import (
        dump_trace_file, read_trace_file,
    )
    from param_tpu_torch.trace.replay import CommsReplay, ReplayParams

    res = {}
    sub = backend.new_group([0, 1], pg_id=3)
    backend.start_trace_recording()
    for coll, kw, shape in record_calls(world):
        backend.collective_fn[coll](CollectiveArgs(
            in_tensor=torch.full(shape, rank + 1.0), **kw))
    if rank in (0, 1):
        backend.collective_fn["all_reduce"](CollectiveArgs(
            group=sub, in_tensor=torch.ones(16)))
    trace = backend.stop_trace_recording()
    res["recorded"] = [{k: v for k, v in e.items() if k != "startTime_ns"}
                       for e in trace]
    path = os.path.join(out_dir, f"recorded{rank}.json")
    dump_trace_file(trace[:len(record_calls(world))], path)

    def replay(trace_or_path, **kw):
        kw.setdefault("do_warmup", False)
        rp = CommsReplay(backend, ReplayParams(**kw))
        out = rp.run(trace_or_path)
        return rp, out

    rp, out = replay(read_trace_file(path), blocking=True)
    res["replay_recorded"] = {k: (v["count"], v["total_bytes"])
                              for k, v in out["collectives"].items()}
    res["replay_sizes"] = [a.in_tensor.shape[0]
                           for a in rp._tensor_cache.values()
                           if hasattr(a, "in_tensor")]
    rp, out = replay(BASIC_TRACE, blocking=True, num_replays=2)
    res["replay_basic"] = {k: (v["count"], v["total_bytes"])
                           for k, v in out["collectives"].items()}
    res["replay_basic_num_ops"] = out["num_ops"]
    rp, out = replay(BASIC_TRACE)
    res["replay_nonblocking"] = sorted(out["collectives"])
    res["dry_run"] = replay(BASIC_TRACE, dry_run=True)[1]["dry_run"]
    rp = CommsReplay(backend, ReplayParams(auto_shrink=True))
    rp.load(shrink_trace(world))
    res["auto_shrink"] = [(o.comms, o.in_msg_size, o.out_msg_size,
                           o.in_split, o.out_split) for o in rp.ops]
    rp = CommsReplay(backend, ReplayParams(rebalance_policy="equal"))
    rp.load([dict(e, in_split=e["in_split"][:world],
                  out_split=e["out_split"][:world])
             for e in shrink_trace(world)[2:]])
    res["rebalance"] = (rp.ops[0].in_split, rp.ops[0].in_msg_size)
    pg_trace = [{"comms": "all_reduce", "in_msg_size": 64,
                 "out_msg_size": 64, "dtype": "float32", "pg_id": 7,
                 "global_ranks": [0, 1]}]
    rp, out = replay(pg_trace, blocking=True)
    res["pg_routing"] = (sorted(rp._pg_cache), rp._pg_cache[7].ranks,
                         out["collectives"].get("all_reduce", {})
                         .get("count"))
    details = os.path.join(out_dir, "details.json")
    rp, _ = replay(BASIC_TRACE, blocking=True, output_path=details)
    with open(rp.details_path()) as f:
        res["details"] = json.load(f)
    # the CLIs: a quantized sweep recorded and exported by rank 0, then
    # replayed from both files in this world
    dump = os.path.join(out_dir, "cli.json")
    et = os.path.join(out_dir, "cli_et.json")
    comms_cli.main(["--device", "cpu", "--collective",
                    "all_reduce,all_to_all", "--b", "1K", "--e", "2K",
                    "--n", "2", "--w", "1", "--bitwidth", "8",
                    "--backend", "torchcomms", "--trace-dump", dump,
                    "--trace-dump-et", et, "--log", "WARNING"])
    backend.barrier()
    for path_, ttype in ((dump, "basic"), (et, "pytorch_et")):
        rc = replay_cli.main(["--device", "cpu", "--trace-path", path_,
                              "--trace-type", ttype, "--blocking",
                              "--output-path",
                              os.path.join(out_dir, f"cli_{ttype}.details"),
                              "--log", "WARNING"])
        rp_ = CommsReplay(backend, ReplayParams(trace_type=ttype,
                                                dry_run=True))
        res[f"cli_replay:{ttype}"] = (rc, rp_.run(read_trace_file(path_))
                                      ["dry_run"])
        res[f"cli_trace:{ttype}"] = read_trace_file(path_)
    return res


def main(mode, store, rank, world, out_dir):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from param_tpu_torch.backend import DistBackend

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    backend = DistBackend("cpu")
    backend.initialize()
    if mode == "trace":
        res = run_trace(backend, rank, world, out_dir)
    else:
        res = {"quant": run_quant, "overlap": run_overlap,
               "torchcomms": run_torchcomms}[mode](backend, rank, world)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    backend.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
