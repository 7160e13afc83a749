"""The port's comms tier against the reference: size and bandwidth
arithmetic, ``CommsParams.from_args``, every collective of the
``torch.distributed`` backend in spawned gloo worlds of 2 and 4 against
``TpuBackend`` on a CPU mesh of the same size fed the same inputs, the
harness's rank-pattern dcheck, ``cli.comms --device cpu`` under torchrun,
the harness at world 1 in this process, and the flags the port refuses.

Inputs are small integers as f32, so sums, products and averages over up
to four ranks are exact in any order: every output must match the
reference exactly.  The spawned ranks (tests/torch_comms_worker.py) import
no JAX; each world runs under its own timeout.
"""

import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from param_tpu.backend import TpuBackend
from param_tpu.backend.base import CollectiveArgs as RefArgs
from param_tpu.cli.comms import build_parser as ref_parser
from param_tpu.comms.harness import CommsBench as RefBench
from param_tpu.comms.harness import CommsParams as RefParams
from param_tpu.utils import bw as ref_bw
from param_tpu.utils import sizes as ref_sizes
from param_tpu_torch.backend import SUPPORTED_COLLECTIVES, CollectiveArgs
from param_tpu_torch.backend import DistBackend
from param_tpu_torch.cli import comms as cli
from param_tpu_torch.comms.coll_bench import CollBench
from param_tpu_torch.comms.harness import CommsBench, CommsParams
from param_tpu_torch.utils import bw, sizes

import torch_comms_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 90
WORLDS = (2, 4)
BUS_BW_COLLECTIVES = SUPPORTED_COLLECTIVES + ["all_gather_base"]


# ------------------------------------------------------- pure functions
@pytest.mark.parametrize("text", ["8", "4K", "1M", "1.5K", "2G", " 64M ", 4096])
def test_parse_size_matches_reference(text):
    assert sizes.parse_size(text) == ref_sizes.parse_size(text)


def test_format_size_and_percentile_match_reference():
    for nbytes in (1, 1000, 1024, 3 * 1024, 1024 ** 2, 5 * 1024 ** 3, 1536):
        assert sizes.format_size(nbytes) == ref_sizes.format_size(nbytes)
    vals = [5.0, 1.0, 4.0, 2.5, 9.0, 7.0]
    for p in (0, 25, 50, 75, 95, 100):
        assert sizes.percentile(vals, p) == ref_sizes.percentile(vals, p)


@pytest.mark.parametrize("args", [(8, 64 * 1024 ** 2, 2, 0, 4),
                                  (1024, 4096, 2, 512, 4), (3, 100, 3, 0, 2),
                                  (16, 16, 2, 0, 4), (8, 1000, 4, 0, 8)])
def test_size_sweep_matches_reference(args):
    b, e, f, i, es = args
    assert sizes.size_sweep(b, e, f, i, elem_size=es) == \
        ref_sizes.size_sweep(b, e, f, i, elem_size=es)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_fix_begin_size_and_bus_bw_match_reference(n):
    for coll in BUS_BW_COLLECTIVES:
        for es in (2, 4):
            assert sizes.fix_begin_size(coll, 8, n, es, 2) == \
                ref_sizes.fix_begin_size(coll, 8, n, es, 2)
        assert bw.bus_bw_factor(coll, n) == ref_bw.bus_bw_factor(coll, n)
        assert bw.bus_bw(coll, 1 << 20, 37.5, n, 32) == \
            ref_bw.bus_bw(coll, 1 << 20, 37.5, n, 32)
    assert bw.alg_bw(1 << 20, 12.5) == ref_bw.alg_bw(1 << 20, 12.5)


ARGVS = [
    ["--mode", "graph"],
    ["--collective", "all_reduce,all_gather", "--b", "1K", "--e", "1M",
     "--f", "4", "--n", "7", "--w", "3", "--c", "1", "--mode", "dispatch",
     "--reduce-op", "max", "--data-type", "bfloat16"],
    ["--coll", "incast", "--src-ranks", "1,2", "--dst-rank", "3", "--i",
     "512", "--mode", "blocking", "--tag", "x"],
    ["--collective", "all_to_allv", "--in-split", "1,2,3,4", "--out-split",
     "4,3,2,1", "--ss", "256,1K", "--multi-comms", "2", "--mode", "graph",
     "--pt2pt", "pairwise", "--window", "9", "--root", "2"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_params_from_args_match_reference(argv):
    got = CommsParams.from_args(cli.build_parser().parse_args(argv))
    want = RefParams.from_args(ref_parser().parse_args(argv))
    for name in CommsParams.__dataclass_fields__:
        g, w = getattr(got, name), getattr(want, name)
        if name == "mode":
            g, w = g.value, w.value
        assert g == w, name


def test_default_mode_is_dispatch():
    """The reference defaults to its scalar-fetch chain (``graph``), built
    for a TPU relay; the port defaults to eager calls timed by CUDA events."""
    assert CommsParams.from_args(cli.build_parser().parse_args([])).mode \
        .value == "dispatch"


class _OneRank:
    """The least of a backend the harness's prep and payload need."""

    def __init__(self, rank):
        self.rank = rank

    def get_global_rank(self):
        return self.rank

    def get_device(self):
        return torch.device("cpu")


@pytest.mark.parametrize("coll", ["all_reduce", "all_gather", "gather",
                                  "reduce_scatter", "all_to_all", "scatter",
                                  "broadcast", "pt2pt", "all_gather_v"])
def test_prep_and_payload_match_reference(backend, coll):
    """Rank r's input is the reference's shard r: same length, filled with
    r + 1; the payload bytes agree."""
    ref = RefBench(backend, RefParams())
    ref_group = backend.get_default_group()
    want = ref.prep_comm(coll, 4096, ref_group).in_tensor
    shards = backend.local_shards(want, ref_group)
    from param_tpu_torch.backend import CommGroup

    group = CommGroup(ranks=list(range(8)))
    for r in (0, 3, 7):
        port = CommsBench(_OneRank(r), CommsParams())
        got = port.prep_comm(coll, 4096, group).in_tensor
        np.testing.assert_array_equal(got.numpy(), shards[r])
        assert port.payload_bytes(coll, 4096, group) == \
            ref.payload_bytes(coll, 4096, ref_group)


# ------------------------------------------------------- spawned worlds
def _spawn_world(n, out_dir):
    store = os.path.join(out_dir, "store")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_comms_worker.py"),
         store, str(r), str(n), out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return procs


def _join(procs, what):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{what} did not finish in {WORLD_TIMEOUT_S} s")
    bad = [(r, p.returncode, log) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, f"{what}: ranks failed: {bad}"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results, both worlds run at once."""
    dirs = {n: str(tmp_path_factory.mktemp(f"world{n}")) for n in WORLDS}
    procs = {n: _spawn_world(n, dirs[n]) for n in WORLDS}
    for n in WORLDS:
        _join(procs[n], f"gloo world of {n}")
    return {n: [torch.load(os.path.join(dirs[n], f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
            for n in WORLDS}


_CASES = [(n, c) for n in WORLDS for c in worker.cases(n)]


@pytest.mark.parametrize("n,case", _CASES,
                         ids=[f"{c[0]}-world{n}" for n, c in _CASES])
def test_collective_matches_tpu_backend(worlds, n, case):
    name, coll, kw, shape = case
    ref = TpuBackend(devices=jax.devices()[:n])
    ref.initialize()
    x = ref.alloc_per_rank(lambda r: worker.inputs(name, n, shape)[r])
    out = ref.collective_fn[coll](RefArgs(in_tensor=x, **kw))
    if coll == "all_gather_v":  # replicated: every rank gets the whole
        want = [np.asarray(out)] * n
    else:
        want = ref.local_shards(out)
    for r in range(n):
        got = worlds[n][r][name].numpy()
        np.testing.assert_array_equal(got, np.asarray(want[r]).reshape(
            got.shape), err_msg=f"rank {r}")
        assert got.shape == np.asarray(want[r]).shape


@pytest.mark.parametrize("n", WORLDS)
def test_object_collectives_match_tpu_backend(worlds, n):
    ref = TpuBackend(devices=jax.devices()[:n])
    ref.initialize()
    objs = [{"rank": r, "v": [r] * r} for r in range(n)]
    gathered = ref.all_gather_object(RefArgs(misc={"objects": objs}))
    per_rank = ref.broadcast_object_list(RefArgs(src_rank=1, misc={
        "object_list": [{"root": 1}, "from 1"]}))
    for r in range(n):
        assert worlds[n][r]["all_gather_object"] == gathered
        assert worlds[n][r]["broadcast_object_list"] == per_rank[r]


@pytest.mark.parametrize("n", WORLDS)
def test_rank_pattern_dcheck_passes(worlds, n):
    for r in range(n):
        checks = {k: v for k, v in worlds[n][r].items()
                  if k.startswith("dcheck:")}
        assert len(checks) == len(worker.DCHECK_COLLECTIVES) + 1
        assert all(v is True for v in checks.values()), checks


@pytest.mark.parametrize("n,call", [(n, c) for n in WORLDS
                                    for c in worker.REUSE_CALLS],
                         ids=[f"{c[0]}-world{n}" for n in WORLDS
                              for c in worker.REUSE_CALLS])
def test_pt2pt_buffer_reuse_matches_tpu_backend(worlds, n, call):
    """Each pt2pt call made twice, the second in the first's receive
    buffers (the window alternating two): both equal the reference's."""
    name, method, extra = call
    ref = TpuBackend(devices=jax.devices()[:n])
    ref.initialize()
    pairs = worker.reuse_pairs(n)
    x = ref.alloc_per_rank(
        lambda r: worker.inputs("pt2pt_reuse", n, (7,))[r])
    out = getattr(ref, method)(RefArgs(
        in_tensor=x, src_ranks=[s for s, _ in pairs],
        dst_ranks=[d for _, d in pairs]), *extra)
    want = ref.local_shards(out)
    for r in range(n):
        first, second, same_buffer = worlds[n][r][f"reuse:{name}"]
        assert same_buffer, f"rank {r}: the second call allocated anew"
        for got in (first, second):
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want[r]).reshape(got.shape),
                err_msg=f"rank {r}")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_torchrun_world_of_2_on_gloo():
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), "-m",
           "param_tpu_torch.cli.comms", "--", "--device", "cpu",
           "--collective",
           "all_reduce,all_gather,reduce_scatter,all_to_all,broadcast,pt2pt",
           "--b", "1K", "--e", "2K", "--n", "3", "--w", "1", "--c", "1",
           "--window", "4"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=WORLD_TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert out.count("COMMS-RES:") == 6, out
    assert "world=2" in out and "BAD" not in out
    rows = re.findall(r"^\s+\d+K\s+\d+\s.*\s(OK|BAD)$", out, re.M)
    assert rows == ["OK"] * 12, out


# ---------------------------------------------------------- world of 1
@pytest.fixture
def world1():
    b = DistBackend("cpu")
    b.initialize()
    yield b
    b.shutdown()


@pytest.mark.parametrize("mode", ["dispatch", "blocking", "graph"])
def test_harness_world_1_in_process(world1, mode):
    params = CommsParams(collectives=["all_reduce", "all_gather",
                                      "reduce_scatter", "all_to_allv",
                                      "all_gather_object"],
                         begin_size=64, end_size=256, num_iters=2,
                         num_warmup_iters=1, dcheck=True)
    params.mode = params.mode.__class__(mode)
    results = CollBench(world1, params, reps=1).run()
    assert len(results) == 5
    for (coll, _), rows in results.items():
        assert [r.size_bytes for r in rows][-1] == 256
        per_call = mode == "blocking" or coll == "all_gather_object"
        for r in rows:
            assert r.dcheck_ok is True
            assert len(r.lat_us) == (2 if per_call else 10)
            assert all(t > 0 for t in r.lat_us) and r.alg_bw_gbs > 0


@pytest.mark.parametrize("coll,kw", [
    ("all_reduce", {}), ("all_reduce", {"red_op": "avg"}), ("reduce", {}),
    ("reduce_scatter", {"red_op": "max"}), ("reduce_scatter_v", {}),
    ("broadcast", {})])
def test_in_place_works_in_the_input(world1, coll, kw):
    """Out of place the input stays as it was; in place the result lies in
    the input's own memory (no copy of the message), with the same values."""
    x = torch.arange(1.0, 9.0)
    out = world1.collective_fn[coll](CollectiveArgs(in_tensor=x, **kw))
    torch.testing.assert_close(x, torch.arange(1.0, 9.0), rtol=0, atol=0)
    assert out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    got = world1.collective_fn[coll](CollectiveArgs(in_tensor=x, in_place=True,
                                                    **kw))
    assert got.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    torch.testing.assert_close(got, out, rtol=0, atol=0)


def test_timed_calls_work_in_place(world1):
    """The dcheck call (and its verdict's all_reduce) works on copies; every
    timed call works in the buffer ``prep_comm`` allocated."""
    seen = []
    fn = world1.collective_fn["all_reduce"]
    world1.collective_fn["all_reduce"] = \
        lambda a: seen.append(a.in_place) or fn(a)
    res = CollBench(world1, CommsParams(dcheck=True, num_iters=2,
                                        num_warmup_iters=1), reps=1) \
        .run_one("all_reduce", 256, world1.get_default_group())
    assert res.dcheck_ok is True
    assert seen[:2] == [False, False] and set(seen[2:]) == {True}
    assert len(seen) == 2 + 1 + 10 * 2  # warm-up, then 10 windows of 2


def test_cli_world_1_in_process(capsys):
    assert cli.main(["--device", "cpu", "--collective", "all_reduce,pt2pt",
                     "--b", "1K", "--e", "4K", "--n", "2", "--w", "1",
                     "--c", "1", "--window", "2"]) == 0
    out = capsys.readouterr().out
    assert "COMMS-RES: all_reduce" in out and "COMMS-RES: pt2pt" in out
    assert out.count("  OK") == 3 + 3 and "BAD" not in out


def test_cli_list(capsys):
    assert cli.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == SUPPORTED_COLLECTIVES


@pytest.mark.parametrize("flags,item", [
    (["--bitwidth", "16"], "item 10"),
    (["--trace-dump", "t.json"], "item 11"),
    (["--trace-dump-et", "t.json"], "item 11"),
    (["--backend", "mock"], "item 10"),
    (["--num-devices", "2"], "leave-outs"),
    (["--coordinator", "localhost:1234"], "leave-outs"),
])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--device", "cpu"] + flags)


def test_quantized_args_raise(world1):
    with pytest.raises(NotImplementedError, match="item 10"):
        world1.all_reduce(CollectiveArgs(in_tensor=torch.ones(4),
                                         bitwidth=8))


def test_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--collective", "all_reduce"])
