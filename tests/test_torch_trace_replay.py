"""The port's comm-trace tier against the reference: the basic, PyTorch-ET
(legacy and modern) and Kineto parsers and the PyTorch-ET exporter on the
inline fixtures of tests/test_pytorch_et.py, their round trip, the
quant / dequant / comm split of a synthetic chrome trace, then in spawned
gloo worlds of 2 and 4 (tests/torch_remainder_worker.py, no JAX in the
children): trace recording (per-rank message sizes, a sub-group's ids),
record -> dump -> blocking replay, the replay of a trace with compute ops,
dry run, auto-shrink, rebalance, per-group routing and the details dump,
and ``cli.comms --trace-dump / --trace-dump-et`` (quantized, through the
facade) replayed by ``cli.replay`` from both files; each against the
reference's ``CommsReplay`` / recording on a CPU mesh of the same size.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from param_tpu.backend import TpuBackend
from param_tpu.backend.base import CollectiveArgs as RefArgs
from param_tpu.trace import comms_trace as ref_ct
from param_tpu.trace import export_pytorch_et as ref_export
from param_tpu.trace import profiler_analysis as ref_pa
from param_tpu.trace import pytorch_et as ref_pet
from param_tpu.trace.replay import CommsReplay as RefReplay
from param_tpu.trace.replay import ReplayParams as RefParams
from param_tpu_torch.cli import replay as replay_cli
from param_tpu_torch.trace import comms_trace as ct
from param_tpu_torch.trace import export_pytorch_et as export
from param_tpu_torch.trace import profiler_analysis as pa
from param_tpu_torch.trace import pytorch_et as pet
from param_tpu_torch.trace.device_trace import quant_comm_split

import torch_remainder_worker as worker
from test_pytorch_et import kineto_fixture, legacy_et_fixture, \
    modern_et_fixture

WORLDS = (2, 4)


def _ops(ops):
    return [dataclasses.asdict(o) for o in ops]


# ----------------------------------------------------- parse and export
@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("target", [0, 1])
def test_pytorch_et_parsers_match_reference(world, target):
    for fixture in (modern_et_fixture, legacy_et_fixture):
        data = fixture(world)
        assert _ops(pet.comms_from_pytorch_et(data, target, world)) == \
            _ops(ref_pet.comms_from_pytorch_et(data, target, world))
        assert _ops(ct.parse_trace(data, "pytorch_et", target, world)) == \
            _ops(ref_ct.parse_trace(data, "pytorch_et", target, world))
    data = kineto_fixture(world)
    for events in (data, data["traceEvents"]):
        assert _ops(pet.comms_from_kineto(events, target)) == \
            _ops(ref_pet.comms_from_kineto(events, target))


def test_basic_parser_matches_reference():
    assert _ops(ct.parse_trace(worker.BASIC_TRACE)) == \
        _ops(ref_ct.parse_trace(worker.BASIC_TRACE))
    for name in ("allreduce", "AllToAll", "reduceScatter", "all-gather",
                 "sendrecv", "allgather_into_tensor_coalesced", "recv"):
        assert ct.to_comm_name(name) == ref_ct.to_comm_name(name)
    with pytest.raises(ValueError, match="neither"):
        ct.parse_trace([{"bogus": 1}])
    with pytest.raises(ValueError, match="unrecognized"):
        ct.parse_trace([], "et")


def test_trace_file_round_trip(tmp_path):
    for name in ("t.json", "t.json.gz"):
        p = str(tmp_path / name)
        ct.dump_trace_file(worker.BASIC_TRACE, p)
        assert ct.read_trace_file(p) == worker.BASIC_TRACE
        assert ref_ct.read_trace_file(p) == worker.BASIC_TRACE


@pytest.mark.parametrize("fixture", [modern_et_fixture, legacy_et_fixture])
@pytest.mark.parametrize("target", [0, 2])
def test_export_matches_reference_and_round_trips(fixture, target):
    ops = pet.comms_from_pytorch_et(fixture(8), target, 8)
    ref_ops = ref_pet.comms_from_pytorch_et(fixture(8), target, 8)
    data = export.export_pytorch_et(ops, 8, target)
    assert data == ref_export.export_pytorch_et(ref_ops, 8, target)
    back = [o for o in pet.comms_from_pytorch_et(data, target, 8)
            if o.comms != "init"]
    want = [o for o in ops if o.comms and o.comms != "init"]
    assert [(o.comms, o.in_msg_size, o.out_msg_size, o.dtype,
             o.in_split or None, o.root) for o in back] == \
        [(o.comms, o.in_msg_size, o.out_msg_size, o.dtype,
          o.in_split or None, o.root) for o in want]


def test_export_of_basic_elements_matches_reference(tmp_path):
    elems = [e for e in worker.BASIC_TRACE if "comms" in e]
    assert export.export_pytorch_et(elems, 4) == \
        ref_export.export_pytorch_et(elems, 4)
    p = str(tmp_path / "et.json.gz")
    export.dump_pytorch_et_file(elems, 4, p)
    assert ct.read_trace_file(p) == ref_export.export_pytorch_et(elems, 4)


def test_profiler_analysis_matches_reference(tmp_path):
    recs = [{"comms": c, "size_bytes": s, "lat_us": t} for c, s, t in [
        ("all_reduce", 4096, 12.5), ("all_reduce", 8192, 20.0),
        ("all_to_all", 1024, 7.0), ("compute:gemm", 0, 3.0),
        ("all_gather", 2048, 9.5)]]
    assert pa.analyze_records(recs, 4, 1) == ref_pa.analyze_records(recs, 4,
                                                                    1)
    paths = []
    for r in range(2):
        paths.append(str(tmp_path / f"d{r}.json"))
        with open(paths[-1], "w") as f:
            json.dump(recs[r:], f)
    assert pa.analyze_files(paths, 2) == ref_pa.analyze_files(paths, 2)
    assert pa.effective_a2a_bytes([1, 2, 3], [3, 2, 1], 1, 4) == \
        ref_pa.effective_a2a_bytes([1, 2, 3], [3, 2, 1], 1, 4)


def test_replay_cli_et_names_item_11b(tmp_path, capsys):
    """Item 11b is ported: ``--trace-type et`` replays the comm ops of a
    saved execution trace (the JAX package's bundled jaxpr trace of a
    sharded train step's collectives, or none) under the mock backend."""
    from param_tpu_torch.trace.execution_trace import ExecutionTrace

    path = str(tmp_path / "et.json")
    ExecutionTrace({
        "schema": "param-tpu-torch-et-1.0",
        "nodes": [{"id": 1, "name": "c10d::allreduce_.default", "parent": 0,
                   "op": True, "inputs": [0], "outputs": [0],
                   "params": {"args": [[{"__tensor__": 0}],
                                       {"__group__": {"size": 2,
                                                      "ranks": [0, 1],
                                                      "rank": 0}},
                                       {"__reduce_op__": "SUM"}, None, False],
                              "kwargs": {}, "n_out": 1},
                   "iter": 0}],
        "tensors": {"0": {"shape": [256], "dtype": "float32"}},
        "in_tensors": [0], "out_tensors": [0]}).save(path)
    rc = replay_cli.main(["--trace-path", path, "--trace-type", "et",
                          "--backend", "mock", "--no-warm-up"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["num_ops"] == 1
    assert report["collectives"]["all_reduce"]["total_bytes"] == 1024


def test_pt2pt_replay_keeps_each_ops_pair():
    """F3: two equal-sized sends between different pairs replay as the
    trace's own pairs (the tensor cache is keyed on the pair too)."""
    from param_tpu_torch.backend import MockBackend
    from param_tpu_torch.trace.replay import CommsReplay, ReplayParams

    trace = [{"comms": "send", "in_msg_size": 256, "out_msg_size": 256,
              "dtype": "float32", "src_rank": s, "dst_rank": d}
             for s, d in ((0, 1), (2, 3), (0, 1))]
    backend = MockBackend(world_size=4)
    rep = CommsReplay(backend, ReplayParams(do_warmup=False))
    rep.run(trace)
    pairs = [(a.src_ranks, a.dst_ranks) for _, a in backend.calls]
    assert pairs == [([e["src_rank"]], [e["dst_rank"]]) for e in trace]
    # the collectives' cache is unchanged: one entry for both all_reduces
    rep2 = CommsReplay(MockBackend(world_size=4), ReplayParams(do_warmup=False))
    rep2.run([{"comms": "all_reduce", "in_msg_size": 256,
               "out_msg_size": 256, "dtype": "float32"}] * 2)
    assert len(rep2._tensor_cache) == 1
    assert len(rep._tensor_cache) == 2


# --------------------------------------------------- quant / comm split
def _kernel(name, ts, dur, corr, tid=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def test_quant_comm_split_on_a_synthetic_trace():
    """Kernels under the GPU-side span of a region; a kernel of a trace
    without that span by its launch inside the CPU-side region; NCCL
    kernels and a copy launched inside a collective's host op (nested
    ops) as comm; host events never counted."""
    events = [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "quantize",
         "pid": 0, "tid": 7, "ts": 100, "dur": 50},
        _kernel("void at::reduce_kernel<abs_max>", 105, 10, 1),
        _kernel("void at::elementwise_kernel<round>", 120, 20, 2),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "dequantize",
         "pid": 0, "tid": 7, "ts": 300, "dur": 40},
        _kernel("void at::elementwise_kernel<mul>", 310, 25, 3),
        _kernel("ncclDevKernel_AllToAll_RING_LL", 160, 100, 4, tid=9),
        _kernel("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)", 400,
                60, 5, tid=9),
        _kernel("void at::elementwise_kernel<copy>", 500, 5, 6),
        # a dequantize kernel known only by its launch's CPU region
        {"ph": "X", "cat": "user_annotation", "name": "dequantize",
         "pid": 1, "tid": 1, "ts": 1000, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 1010, "dur": 4,
         "args": {"correlation": 8}},
        _kernel("void at::elementwise_kernel<mul>", 1100, 15, 8, tid=11),
        # a one-rank collective's copy, launched inside its c10d op
        {"ph": "X", "cat": "cpu_op", "name": "c10d::allgather_base_",
         "pid": 1, "tid": 1, "ts": 2000, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "nccl:_all_gather_base",
         "pid": 1, "tid": 1, "ts": 2010, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "pid": 1, "tid": 1, "ts": 2045, "dur": 3,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "pid": 0,
         "tid": 7, "ts": 2100, "dur": 12, "args": {"correlation": 9}},
        # host events
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1,
         "tid": 1, "ts": 1005, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "quantize", "pid": 1,
         "tid": 1, "ts": 90, "dur": 40},
    ]
    split = quant_comm_split(events)
    assert split == {"comm": {"count": 3, "total_us": 172.0},
                     "quant": {"count": 2, "total_us": 30.0},
                     "dequant": {"count": 2, "total_us": 40.0},
                     "other": {"count": 1, "total_us": 5.0}}


# ------------------------------------------------------- spawned worlds
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return worker.run_worlds("trace", WORLDS, tmp_path_factory)


def _ref(n):
    b = TpuBackend(devices=jax.devices()[:n])
    b.initialize()
    return b


def _reference_recording(n):
    ref = _ref(n)
    sub = ref.new_group([0, 1], pg_id=3)
    ref.start_trace_recording()
    for coll, kw, shape in worker.record_calls(n):
        x = ref.alloc_per_rank(lambda r: np.full(shape, r + 1.0, np.float32))
        ref.collective_fn[coll](RefArgs(in_tensor=x, **kw))
    ref.collective_fn["all_reduce"](RefArgs(
        group=sub, in_tensor=ref.alloc_per_rank(
            lambda r: np.ones(16, np.float32), sub)))
    ref.complete_ops()
    trace = ref.stop_trace_recording()
    return [{k: v for k, v in e.items() if k != "startTime_ns"}
            for e in trace]


@pytest.mark.parametrize("n", WORLDS)
def test_recording_matches_reference(worlds, n):
    want = _reference_recording(n)
    k = len(worker.record_calls(n))
    for r in range(n):
        got = worlds[n][r]["recorded"]
        assert got[:k] == want[:k], f"rank {r}"
        assert got[k:] == (want[k:] if r < 2 else [])


def _counts(report):
    return {k: (v["count"], v["total_bytes"])
            for k, v in report["collectives"].items()}


@pytest.mark.parametrize("n", WORLDS)
def test_record_dump_replay_matches_reference(worlds, n):
    rp = RefReplay(_ref(n), RefParams(blocking=True, do_warmup=False))
    want = _counts(rp.run([dict(e, startTime_ns=0) for e in
                           _reference_recording(n)[:len(
                               worker.record_calls(n))]]))
    sizes = [a.in_tensor.shape[0] for a in rp._tensor_cache.values()
             if hasattr(a, "in_tensor")]
    for r in range(n):
        assert worlds[n][r]["replay_recorded"] == want, f"rank {r}"
        assert [s * n for s in worlds[n][r]["replay_sizes"]] == sizes


@pytest.mark.parametrize("n", WORLDS)
def test_replay_with_compute_matches_reference(worlds, n):
    ref = _ref(n)
    rp = RefReplay(ref, RefParams(blocking=True, num_replays=2,
                                  do_warmup=False))
    out = rp.run(worker.BASIC_TRACE)
    dry = RefReplay(ref, RefParams(dry_run=True)).run(
        worker.BASIC_TRACE)["dry_run"]
    for r in range(n):
        res = worlds[n][r]
        assert res["replay_basic"] == _counts(out)
        assert res["replay_basic_num_ops"] == out["num_ops"]
        assert res["replay_nonblocking"] == sorted(out["collectives"])
        assert res["dry_run"] == dry


@pytest.mark.parametrize("n", WORLDS)
def test_shrink_rebalance_routing_details_match_reference(worlds, n):
    ref = _ref(n)
    rp = RefReplay(ref, RefParams(auto_shrink=True))
    rp.load(worker.shrink_trace(n))
    shrink = [(o.comms, o.in_msg_size, o.out_msg_size, o.in_split,
               o.out_split) for o in rp.ops]
    rp = RefReplay(ref, RefParams(rebalance_policy="equal"))
    rp.load([dict(e, in_split=e["in_split"][:n],
                  out_split=e["out_split"][:n])
             for e in worker.shrink_trace(n)[2:]])
    rebalance = (rp.ops[0].in_split, rp.ops[0].in_msg_size)
    rp = RefReplay(ref, RefParams(blocking=True, do_warmup=False))
    out = rp.run([{"comms": "all_reduce", "in_msg_size": 64,
                   "out_msg_size": 64, "dtype": "float32", "pg_id": 7,
                   "global_ranks": [0, 1]}])
    routing = ([7], rp._pg_cache[7].size, out["collectives"]["all_reduce"]
               ["count"])
    rp = RefReplay(ref, RefParams(blocking=True, do_warmup=False))
    rp.run(worker.BASIC_TRACE)
    details = [(r.op_id, r.comms, r.size_bytes, r.marker) for r in rp.records]
    for r in range(n):
        res = worlds[n][r]
        assert res["auto_shrink"] == shrink
        assert res["rebalance"] == rebalance
        pgs, ranks, count = res["pg_routing"]
        assert (pgs, len(ranks)) == routing[:2] and ranks == [0, 1]
        assert count == (routing[2] if r < 2 else None)
        assert [(d["id"], d["comms"], d["size_bytes"], d["marker"])
                for d in res["details"]] == details
        assert all(d["lat_us"] > 0 for d in res["details"])


@pytest.mark.parametrize("n", WORLDS)
def test_cli_trace_dump_and_replay_match_reference(worlds, n):
    """cli.comms --bitwidth 8 --backend torchcomms --trace-dump /
    --trace-dump-et in the world, replayed by cli.replay from both files;
    the dry runs of both files equal the reference's of the same files, and
    each other."""
    basic = worlds[n][0]["cli_trace:basic"]
    et = worlds[n][0]["cli_trace:pytorch_et"]
    assert et == ref_export.export_pytorch_et(basic, n)
    ref = _ref(n)
    want_basic = RefReplay(ref, RefParams(dry_run=True)).run(basic)["dry_run"]
    want_et = RefReplay(ref, RefParams(dry_run=True, trace_type="pytorch_et")
                        ).run(et)["dry_run"]
    assert {k: v for k, v in want_et.items() if k != "init"} == want_basic
    for r in range(n):
        res = worlds[n][r]
        assert res["cli_replay:basic"] == (0, want_basic)
        assert res["cli_replay:pytorch_et"] == (0, want_et)
    # a sweep of 2 sizes x (all_reduce, all_to_all), 2 warm-up + 2 timed
    # windows of 10: the recorded counts
    assert {k: v["count"] for k, v in want_basic.items()} == \
        {"all_reduce": 2 * (1 + 2 * 10), "all_to_all": 2 * (1 + 2 * 10)}
