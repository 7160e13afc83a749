"""The execution trace of the port's table-wise sharded dense step in a gloo
world of 2 (ranks of ``tests/torch_et_worker.py``, no JAX in the children)
against the JAX package's capture of its ``shard_map`` step on a CPU mesh of
2 (as ``tests/test_et.py``'s ``TestShardedScalingStructure`` builds it), fed
the same full parameters and batch.

- Each rank's replay of its own capture, on the live world, equals its
  direct step and the JAX step's updated parameters and loss for that
  rank's shard (rtol 1e-5, atol 1e-6), and leaves the given inputs alone.
  Each rank runs ``experiments.et_sharded.check``, the capture -> replay ->
  compare path that the card's check runs.
- The all_to_all ops of the port's ``comms_from_et``, in order, with their
  per-rank element counts, equal those of ``param_tpu.trace.comms_trace.
  comms_from_et`` for the JAX capture.  The all_reduces are compared by
  element count.  The gradients' carry the same elements, folded
  differently: the port's ``all_reduce_mean`` sends each MLP's gradients as
  one concatenation (the top MLP's, then the bottom's), the JAX step one
  ``psum`` a leaf (the bottom MLP's, then the top's).  The loss is folded
  differently too: the JAX step differentiates the global mean loss, whose
  forward ``psum`` (which also gives the reported loss) and that psum's
  transpose in the backward are two 1-element psums before the gradients';
  the port differentiates the local loss and means only the reported loss,
  one 1-element all_reduce after them.  So the JAX total is the port's
  plus one.
- ``cli.replay --trace-type et`` replays the comm ops of a rank's trace and
  of the JAX capture under the mock backend; on the JAX-package file the
  port's ``comms_from_et`` gives the JAX function's ops.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from param_tpu.models import dlrm as jdlrm
from param_tpu.models.dlrm_data import RandomDataset
from param_tpu.trace.capture import capture_execution_trace as ref_capture
from param_tpu.trace.comms_trace import comms_from_et as ref_comms_from_et
from param_tpu_torch.cli import replay as replay_cli
from param_tpu_torch.experiments.et_sharded import LR
from param_tpu_torch.models.convert import params_shard_from_jax
from param_tpu_torch.trace.capture import tensor_leaves
from param_tpu_torch.trace.comms_trace import comms_from_et
from param_tpu_torch.trace.execution_trace import ExecutionTrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 120
TINY = dict(num_tables=4, rows_per_table=512, emb_dim=16, nnz=4, dense_dim=16,
            bot_mlp=[32, 16], top_mlp=[32, 1], batch=64)


def _inputs():
    cfg = jdlrm.DlrmConfig(**TINY)
    params = jax.tree.map(np.asarray,
                          jdlrm.init_dlrm_params(jax.random.PRNGKey(0), cfg))
    batch = next(iter(RandomDataset(batch=64, dense_dim=16, num_tables=4,
                                    nnz=4, num_rows=512, num_batches=1)))
    return dict(cfg=TINY, params=params, batch=batch)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results and the path of its saved trace."""
    base = tmp_path_factory.mktemp("et_world")
    in_file = str(base / "inputs.pkl")
    with open(in_file, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_et_worker.py"),
         str(base / "store"), str(r), str(WORLD), in_file, str(base)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"gloo world of {WORLD} did not finish in {TIMEOUT_S} s")
    bad = [(r, p.returncode, log) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, f"ranks failed: {bad}"
    return [(torch.load(str(base / f"rank{r}.pt"), weights_only=False),
             str(base / f"rank{r}_et.json")) for r in range(WORLD)]


def _jax_step():
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("x",))
    model = jdlrm.DlrmModel(jdlrm.DlrmConfig(**TINY), mesh)
    data = _inputs()
    params, batch = model.place(data["params"], data["batch"])
    opt = optax.sgd(LR)
    return model.make_train_step(opt), (params, opt.init(params), *batch)


@pytest.fixture(scope="module")
def jax_et(tmp_path_factory):
    """The JAX package's capture of its sharded SGD step, saved."""
    step, args = _jax_step()
    et = ref_capture(step, *args)
    path = str(tmp_path_factory.mktemp("jax_et") / "sharded_et.json.gz")
    et.save(path)
    return path


@pytest.fixture(scope="module")
def jax_out():
    """Each rank's shard of the JAX step's updated parameters, then its
    loss, in the order of the port's step outputs."""
    step, args = _jax_step()
    new, _, loss = step(*args)
    new = jax.tree.map(np.asarray, new)
    return [[t.detach().numpy() for t in tensor_leaves(
        params_shard_from_jax(new, r, WORLD, "cpu"))] + [np.asarray(loss)]
        for r in range(WORLD)]


@pytest.mark.parametrize("rank", range(WORLD))
def test_replay_equals_the_direct_step(world, rank):
    res, _ = world[rank]
    rec = res["record"]
    assert rec["errors"] == {} and rec["num_skipped"] == 0
    assert rec["inputs_unchanged"] and rec["ok"]
    assert (rec["rank"], rec["world"]) == (rank, WORLD)
    assert len(res["replayed"]) == len(res["direct"]) == 10  # 9 leaves, loss
    for got, want in zip(res["replayed"], res["direct"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rank", range(WORLD))
def test_replay_equals_the_jax_step(world, jax_out, rank):
    res, _ = world[rank]
    want = jax_out[rank]
    assert [w.shape for w in want] == [g.shape for g in res["replayed"]]
    for got, w in zip(res["replayed"], want, strict=True):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
    # the step really trained this rank's tables
    assert not np.allclose(want[0], tensor_leaves(params_shard_from_jax(
        _inputs()["params"], rank, WORLD, "cpu"))[0].detach().numpy())


@pytest.mark.parametrize("rank", range(WORLD))
def test_comm_ops_match_jax(world, jax_et, rank):
    res, _ = world[rank]
    assert res["comm_nodes"] == ["c10d::alltoall_base_.default"] * 3 + \
        ["c10d::allreduce_.default"] * 3
    ref = ref_comms_from_et(ExecutionTrace.load(jax_et), WORLD)
    ref = [(c.comms, c.in_msg_size, c.out_msg_size) for c in ref]
    port = [(c, i, o) for c, i, o, w in res["comms"]]
    assert all(w == WORLD for *_, w in res["comms"])
    a2a = [c for c in port if c[0] == "all_to_all"]
    assert a2a == [c for c in ref if c[0] == "all_to_all"]
    ids = 64 // WORLD * 4 * 4  # this rank's (b, T, nnz) ids
    pooled = 64 * 4 // WORLD * 16  # the (B, T/n, D) pooled rows
    assert a2a == [("all_to_all", ids, ids), ("all_to_all", pooled, pooled),
                   ("all_to_all", pooled, pooled)]
    ar, ref_ar = ([c[1] for c in ops if c[0] == "all_reduce"]
                  for ops in (port, ref))
    assert len(ar) == 3 and len(ref_ar) == 2 + 8  # a psum per MLP leaf
    assert ar[2] == 1 and ref_ar[:2] == [1, 1]  # the loss
    assert ar[0] == sum(ref_ar[6:]) and ar[1] == sum(ref_ar[2:6])
    assert sum(ar) + 1 == sum(ref_ar)


def test_jax_vocabulary_matches_the_jax_function(jax_et):
    from param_tpu.trace.execution_trace import ExecutionTrace as RefEt

    ours = comms_from_et(ExecutionTrace.load(jax_et), WORLD)
    ref = ref_comms_from_et(RefEt.load(jax_et), WORLD)
    assert [dataclasses.asdict(o) for o in ours] == \
        [dataclasses.asdict(o) for o in ref]


@pytest.mark.parametrize("which", ["port_rank0", "port_rank1", "jax"])
def test_cli_replay_et_under_mock(world, jax_et, which, capsys):
    path = jax_et if which == "jax" else world[int(which[-1])][1]
    want = len(comms_from_et(ExecutionTrace.load(path), WORLD))
    assert want > 0
    rc = replay_cli.main(["--trace-path", path, "--trace-type", "et",
                          "--backend", "mock", "--blocking",
                          "--no-warm-up"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["num_ops"] == want
    assert sum(c["count"] for c in report["collectives"].values()) == want
