"""The port's torchcomms-style facade and mock backend: every communicator
call, sync and async, in spawned gloo worlds of 2 and 4
(tests/torch_remainder_worker.py, no JAX in the children) against the
plain ``DistBackend``'s result for the same collective on the same inputs,
exactly (integer-valued f32); the ``torchcomms`` backend's dispatch table
against the plain table, its quantized all_reduce deferring to the plain
path, a split sub-communicator, the object collectives, every collective of
the sweep through the facade with dcheck, and trace recording under the
facade.  The mock backend and the registry against the reference's in this
process.
"""

import numpy as np
import pytest
import torch

from param_tpu.backend import MockBackend as RefMock
from param_tpu.backend import ReduceOp as RefReduceOp
from param_tpu.backend.base import CollectiveArgs as RefArgs
from param_tpu_torch.backend import (
    SUPPORTED_COLLECTIVES, CollectiveArgs, MockBackend, ReduceOp,
    TorchcommsBackend, get_backend_cls, list_backends,
)
from param_tpu_torch.backend.torchcomms import Work
from param_tpu_torch.cli import comms as cli
from param_tpu_torch.comms.coll_bench import CollBench
from param_tpu_torch.comms.harness import CommsParams

import torch_remainder_worker as worker

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return worker.run_worlds("torchcomms", WORLDS, tmp_path_factory)


def _names(n):
    return sorted(k for k in ("all_reduce_sum", "all_reduce_max",
                              "all_reduce_avg", "reduce_root1",
                              "reduce_avg_root0", "all_gather", "all_to_all",
                              "broadcast_root1", "reduce_scatter_sum",
                              "reduce_scatter_max", "reduce_scatter_v",
                              "gather_root1", "scatter_root1",
                              "all_gather_v", "all_to_all_v", "send_recv",
                              "incast", "multicast"))


_CALLS = [(n, c) for n in WORLDS for c in _names(n)]


@pytest.mark.parametrize("n,call", _CALLS,
                         ids=[f"{c}-world{n}" for n, c in _CALLS])
def test_facade_call_matches_plain_backend(worlds, n, call):
    for r in range(n):
        got = worlds[n][r]["facade"][call]
        want = worlds[n][r]["plain"][call]
        assert got.shape == want.shape, (call, r)
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   msg=f"{call} rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_backend_table_matches_plain_and_keeps_inputs(worlds, n):
    for r in range(n):
        res = worlds[n][r]
        for key in res["facade"]:
            if key.startswith("table:"):
                torch.testing.assert_close(res["facade"][key],
                                           res["plain"][key], rtol=0, atol=0)
                assert res[f"input_kept:{key[6:]}"], key


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("bw", [8, 16])
def test_quantized_all_reduce_defers_to_plain(worlds, n, bw):
    for r in range(n):
        res = worlds[n][r]
        torch.testing.assert_close(res["facade"][f"quant:{bw}"],
                                   res["plain"][f"quant:{bw}"], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("n", WORLDS)
def test_split_and_object_collectives(worlds, n):
    xs = [torch.from_numpy(worker.facade_inputs(n, r)) for r in range(n)]
    for r in range(n):
        res = worlds[n][r]
        if r < 2:
            assert res["split_size"] == 2
            torch.testing.assert_close(res["split"], xs[0] + xs[1])
        else:
            assert "split" not in res
        assert res["objects"] == [{"rank": i} for i in range(n)]
        assert res["object_list"] == ["from 1"]


@pytest.mark.parametrize("n", WORLDS)
def test_sweep_through_facade_dchecks(worlds, n):
    for r in range(n):
        checks = worlds[n][r]["dchecks"]
        assert len(checks) == 19
        assert all(v is True for v in checks.values()), checks


@pytest.mark.parametrize("n", WORLDS)
def test_recording_under_facade(worlds, n):
    for r in range(n):
        res = worlds[n][r]
        assert res["table_restored"]
        assert [(e["comms"], e["in_msg_size"], e["out_msg_size"],
                 e["world_size"]) for e in res["recorded"]] == [
            ("all_reduce", 8, 8, n), ("all_gather", 8, 8 * n, n)]


# ------------------------------------------------------------ in-process
def test_registry():
    assert list_backends() == ["dist", "mock", "torchcomms"]
    assert get_backend_cls("torchcomms") is TorchcommsBackend
    assert get_backend_cls("mock") is MockBackend
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend_cls("tpu")


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PRODUCT", "AVG"])
def test_reduce_op_values_match_reference(op):
    from param_tpu.backend.torchcomms import _red as ref_red
    from param_tpu_torch.backend.torchcomms import _red

    assert ReduceOp[op].value == RefReduceOp[op].value
    for form in (ReduceOp[op], op, op.lower(), ReduceOp[op].value):
        want = ref_red(RefReduceOp[op] if isinstance(form, ReduceOp)
                       else form)
        assert _red(form) == want


def test_work_waits_once_and_finishes():
    class Pending:
        waits = 0

        def wait(self, *a):
            Pending.waits += 1

    w = Work(torch.ones(3), Pending(), lambda t: t * 2)
    assert w.wait() and w.wait()
    assert Pending.waits == 1
    torch.testing.assert_close(w.result(), torch.full((3,), 2.0))


def test_mock_matches_reference_mock():
    got, want = MockBackend(world_size=4, rank=2), RefMock(world_size=4,
                                                           rank=2)
    assert sorted(got.collective_fn) == sorted(want.collective_fn)
    assert sorted(got.collective_fn) == sorted(SUPPORTED_COLLECTIVES
                                               + ["noop"])
    x = torch.arange(6.0)
    for name in ("all_reduce", "broadcast", "pt2pt"):
        assert got.collective_fn[name](CollectiveArgs(in_tensor=x)) is x
        want.collective_fn[name](RefArgs(in_tensor=x.numpy()))
    assert [c for c, _ in got.calls] == [c for c, _ in want.calls]
    assert got.get_world_size() == 4 and got.get_global_rank() == 2
    assert got.get_default_group().ranks == [0, 1, 2, 3]
    g = got.new_group([1, 3], pg_id=2)
    assert g.ranks == [1, 3] and got.get_groups()[-1] is g
    a = np.arange(4.0, dtype=np.float32).reshape(2, 2)
    for name in ("gemm", "add", "sub"):
        np.testing.assert_array_equal(
            got.compute_fn[name](torch.from_numpy(a),
                                 torch.from_numpy(a)).numpy(),
            want.compute_fn[name](a, a))


def test_mock_runs_the_harness():
    b = MockBackend()
    params = CommsParams(collectives=["all_reduce", "all_gather"],
                         begin_size=64, end_size=128, num_iters=2,
                         num_warmup_iters=1, dcheck=True)
    results = CollBench(b, params, reps=1).run()
    assert all(r.dcheck_ok for rows in results.values() for r in rows)
    assert {c for c, _ in b.calls} == {"all_reduce", "all_gather"}


@pytest.mark.parametrize("mode", ["dispatch", "blocking"])
def test_cli_backend_mock_needs_no_process_group(capsys, mode):
    import torch.distributed as dist

    assert cli.main(["--backend", "mock", "--mode", mode, "--collective",
                     "all_reduce", "--b", "1K", "--e", "2K", "--n", "2",
                     "--c", "1"]) == 0
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert "(mock, none)" in out and out.count("  OK") == 2


def test_cli_backend_torchcomms_world_1(capsys):
    assert cli.main(["--device", "cpu", "--backend", "torchcomms",
                     "--collective", "all_reduce,all_gather,reduce_scatter,"
                     "all_to_all,broadcast,pt2pt", "--b", "1K", "--e", "2K",
                     "--n", "2", "--w", "1", "--c", "1", "--window",
                     "2"]) == 0
    out = capsys.readouterr().out
    assert "(torchcomms, gloo)" in out and out.count("COMMS-RES:") == 6
    assert out.count("  OK") == 12 and "BAD" not in out
