"""The port's execution-trace tier against the JAX package's, on the CPU.

- Data model: the JAX package's three bundled jaxpr traces load into the
  port's ``ExecutionTrace`` with the same op and comm-op counts,
  iterations, validation, graphviz text and ``comms_from_et`` ops as
  ``param_tpu``'s; save / load round trips; a bad schema raises.
- Capture and replay: ``tanh(x @ w)``, the DLRM forward and the
  ``dlrm_train`` SGD step at ``cli.et``'s sizes (weights carried across by
  ``models/convert.params_from_jax``): the port's replay of its own capture
  equals ``param_tpu``'s ``EtReplayManager`` replay of its capture and the
  JAX direct call, leaves matched by their path in the tree (rtol 1e-6 for
  ``tanh``; rtol 1e-5, atol 1e-6 / 1e-5 for the DLRM, as
  ``tests/test_torch_dlrm.py``).  The sparse SGD / Adagrad steps replay
  bitwise equal to the direct call, through their ``param_tpu_torch::``
  kernel nodes.
- The replay's machinery: comp / comm mode filters, lazy allocation,
  the skip config and its update on a failing node, .npz inputs,
  multi-iteration replays that copy mutated inputs each iteration, device
  markers in place of device strings, the refusal of a jaxpr trace, and
  the generated script run in a subprocess with ``--device cpu``.

Inputs are made from seeds with numpy.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.cli import et as ref_cli
from param_tpu.trace import comms_trace as ref_ct
from param_tpu.trace import execution_trace as ref_et
from param_tpu.trace.capture import capture_execution_trace as ref_capture
from param_tpu.trace.et_replay import EtReplayManager as RefManager
from param_tpu_torch.backend import DistBackend, MockBackend
from param_tpu_torch.cli import et as cli
from param_tpu_torch.kernels.emb_gather import emb_gather_plain
from param_tpu_torch.kernels.sparse_update import sparse_update_plain
from param_tpu_torch.models.convert import params_from_jax
from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
from param_tpu_torch.ops.mlp import Sgd, tree_map
from param_tpu_torch.trace import comms_trace as ct
from param_tpu_torch.trace.capture import (
    capture_execution_trace, inputs_for, tensor_leaves,
)
from param_tpu_torch.trace.et_replay import (
    AllocationMode, EtReplayManager, ReplayConfig, ReplayMode, generate_code,
)
from param_tpu_torch.trace.execution_trace import (
    JAX_SCHEMA, SCHEMA, ExecutionTrace, TraceValidator,
)
from param_tpu_torch.trace.replay import CommsReplay, ReplayParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(ROOT, "tests", "fixtures", f"{n}_et.json.gz")
            for n in ("linear", "dlrm_train", "transformer_block")]
CFG = dict(num_tables=4, rows_per_table=1000, emb_dim=16, nnz=4, dense_dim=16,
           bot_mlp=[32, 16], top_mlp=[32, 1], batch=64)


def _ops(ops):
    return [dataclasses.asdict(o) for o in ops]


def _path(kp) -> str:
    """A pytree key path (JAX's or torch's) as 'key/index/...'."""
    parts = []
    for k in kp:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _by_path_jax(tree):
    return {_path(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _by_path_torch(tree):
    return {_path(p): v.detach().numpy() for p, v in
            torch.utils._pytree.tree_flatten_with_path(tree)[0]
            if isinstance(v, torch.Tensor)}


def _clone(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(
        t.requires_grad), tree)


# ------------------------------------------------------------ data model
@pytest.mark.parametrize("path", FIXTURES)
def test_data_model_matches_jax(path):
    et, ref = ExecutionTrace.load(path), ref_et.ExecutionTrace.load(path)
    v, rv = TraceValidator(et), ref_et.TraceValidator(ref)
    assert et.schema == JAX_SCHEMA
    assert v.num_ops() == rv.num_ops() > 3
    assert v.num_comm_ops() == rv.num_comm_ops()
    assert et.iterations() == ref.iterations()
    assert v.validate() == rv.validate() == []
    assert et.to_graphviz() == ref.to_graphviz()
    assert et.to_json() == ref.to_json()
    for world in (1, 4):
        assert _ops(ct.comms_from_et(et, world)) == \
            _ops(ref_ct.comms_from_et(ref, world))


@pytest.mark.parametrize("name", ["t.json", "t.json.gz"])
def test_save_load_round_trip(tmp_path, name):
    x, w = torch.ones(4, 8), torch.ones(8, 8)
    et = capture_execution_trace(lambda x, w: torch.tanh(x @ w), x, w,
                                 iterations=2)
    path = str(tmp_path / name)
    et.save(path)
    back = ExecutionTrace.load(path)
    assert back.schema == SCHEMA
    assert back.to_json() == et.to_json()
    assert back.iterations() == 2
    assert TraceValidator(back).validate() == []


def test_bad_schema_raises():
    with pytest.raises(ValueError, match="unsupported ET schema"):
        ExecutionTrace({"schema": "bogus-1.0", "nodes": []})


# --------------------------------------------- capture and replay vs JAX
def test_tanh_matmul_replay_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.random((4, 8), dtype=np.float32)
    w = rng.random((8, 8), dtype=np.float32)
    jet = ref_capture(lambda x, w: jnp.tanh(x @ w), jnp.asarray(x),
                      jnp.asarray(w))
    rm = RefManager(jet, inputs=dict(zip(jet.in_tensors, (x, w))))
    assert rm.replay(iters=1)["errors"] == {}
    want = np.asarray(rm.registry[jet.out_tensors[0]])
    et = capture_execution_trace(lambda x, w: torch.tanh(x @ w),
                                 torch.from_numpy(x), torch.from_numpy(w))
    assert [n.name for n in et.get_nodes()] == ["aten::mm.default",
                                                "aten::tanh.default"]
    mgr = EtReplayManager(et, inputs=dict(zip(et.in_tensors, (x, w))),
                          device="cpu")
    out = mgr.replay(iters=2, warmup=1)
    assert out["errors"] == {} and out["num_skipped"] == 0
    np.testing.assert_allclose(mgr.outputs()[0].numpy(), want, rtol=1e-6)


def _port_workload(name, jargs):
    """The port's (fn, args) of a ``cli.et`` DLRM workload on the JAX
    workload's parameters and batch."""
    model = DlrmModel(DlrmConfig(**CFG), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jargs[0]), "cpu")
    batch = [torch.from_numpy(np.array(a)) for a in
             (jargs[1:] if name == "dlrm" else jargs[2:])]
    if name == "dlrm":
        def forward(p, d, i):
            with torch.no_grad():
                return model.forward(p, d, i)

        return forward, lambda: (_clone(params), *batch)
    opt = Sgd(0.01)
    return model.make_train_step(opt), lambda: (_clone(params), None, *batch)


def _jax_et(fn, *args):
    """The JAX package's capture of ``fn``, its scatter-add nodes replayable.

    Its capture marks ``scatter-add`` opaque (the eqn's params hold an
    update jaxpr), and its replay then skips the node with random outputs;
    without the mark the replay binds it through its own scatter path
    (``param_tpu.trace.et_replay.bind_node``), which needs none of those
    params."""
    data = ref_capture(fn, *args).to_json()
    for n in data["nodes"]:
        if n["name"] == "scatter-add" and "__scopes__" not in n["params"]:
            n["params"].pop("opaque", None)
    return ref_et.ExecutionTrace(data)


@pytest.mark.parametrize("name", ["dlrm", "dlrm_train"])
def test_dlrm_replay_matches_jax(name):
    jfn, jargs = ref_cli._workload(name)
    jet = _jax_et(jfn, *jargs)
    rm = RefManager(jet, inputs=dict(zip(jet.in_tensors,
                                         jax.tree.leaves(jargs))))
    out = rm.replay(iters=1)
    assert out["errors"] == {} and out["num_skipped"] == 0
    jax_direct = jfn(*jargs)
    paths = [_path(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jax_direct)[0]]
    jax_replay = {p: np.asarray(rm.registry[t])
                  for p, t in zip(paths, jet.out_tensors)}
    jax_direct = _by_path_jax(jax_direct)

    fn, args = _port_workload(name, jargs)
    et = capture_execution_trace(fn, *args())
    assert sum(n.name == "param_tpu_torch::emb_gather.default"
               for n in et.get_nodes()) == 1
    given = args()
    mgr = EtReplayManager(et, inputs=inputs_for(et, *given), device="cpu")
    out = mgr.replay(iters=2, warmup=1)
    assert out["errors"] == {} and out["num_skipped"] == 0
    direct = fn(*args())
    ppaths = [_path(p) for p, v in
              torch.utils._pytree.tree_flatten_with_path(direct)[0]
              if isinstance(v, torch.Tensor)]
    port = {p: t.numpy() for p, t in zip(ppaths, mgr.outputs())}
    assert set(port) == set(jax_replay) == set(jax_direct)
    for p in port:
        atol = 1e-5 if p in ("", "2") else 1e-6  # logits, loss
        np.testing.assert_allclose(port[p], jax_replay[p], rtol=1e-5,
                                   atol=atol, err_msg=p)
        np.testing.assert_allclose(port[p], jax_direct[p], rtol=1e-5,
                                   atol=atol, err_msg=p)
    # the replay copied the inputs: the caller's tensors are unchanged
    for a, b in zip(tensor_leaves(given), tensor_leaves(args())):
        assert torch.equal(a, b)


def _sparse_case(opt):
    model = DlrmModel(DlrmConfig(**CFG), device="cpu")
    rng = np.random.default_rng(3)
    dense = torch.from_numpy(rng.random((64, 16), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, 1000, (64, 4, 4)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 2, 64).astype(np.float32))
    params = model.init_params(0)
    if opt == "sgd":
        return model.make_sparse_sgd_step(0.05), \
            lambda: (_clone(params), dense, idx, labels)

    def args():
        p = _clone(params)
        return p, model.init_adagrad_state(p), dense, idx, labels

    return model.make_sparse_adagrad_step(0.05), args


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_sparse_step_replay_is_bitwise(opt):
    step, args = _sparse_case(opt)
    et = capture_execution_trace(step, *args())
    names = [n.name for n in et.get_nodes()]
    assert names.count("param_tpu_torch::sparse_update.default") == 1
    assert names.count("param_tpu_torch::emb_gather.default") == 1
    upd = next(n for n in et.get_nodes() if n.name.startswith(
        "param_tpu_torch::sparse_update"))
    assert set(upd.outputs) <= set(upd.inputs) and upd.outputs  # in place
    mgr = EtReplayManager(et, inputs=inputs_for(et, *args()), device="cpu")
    assert mgr.replay(iters=2, warmup=1)["errors"] == {}
    want = tensor_leaves(step(*args()))
    assert len(want) == len(mgr.outputs())
    for g, w in zip(mgr.outputs(), want):
        assert torch.equal(g, w.detach())


def test_kernel_ops_on_the_cpu_are_the_plain_versions():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.random((50, 8), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(-50, 50, (6, 3)).astype(np.int32))
    w = torch.from_numpy(rng.random((6, 3), dtype=np.float32))
    got = torch.ops.param_tpu_torch.emb_gather.default(table, idx, w)
    assert torch.equal(got, emb_gather_plain(table, idx, w))
    meta = torch.ops.param_tpu_torch.emb_gather.default(
        table.to("meta"), idx.to("meta"))
    assert meta.shape == (6, 8) and meta.device.type == "meta"
    rows = torch.tensor([3, 7, 49], dtype=torch.int32)
    upd = torch.from_numpy(rng.random((3, 8), dtype=np.float32))
    t1, t2 = table.clone(), table.clone()
    a1, a2 = torch.full_like(table, 0.1), torch.full_like(table, 0.1)
    torch.ops.param_tpu_torch.sparse_update.default(t1, rows, upd, a1, 0.05,
                                                    1e-7)
    sparse_update_plain(t2, rows, upd, a2, lr=0.05, eps=1e-7)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)
    schema = torch.ops.param_tpu_torch.sparse_update.default._schema
    assert [a.name for a in schema.arguments if a.alias_info is not None
            and a.alias_info.is_write] == ["table", "acc"]


# ------------------------------------------------ the replay's machinery
@pytest.fixture
def world1():
    b = DistBackend("cpu")
    b.initialize()
    yield b
    b.shutdown()


def _sharded_capture(backend):
    model = DlrmModel(DlrmConfig(**CFG), group=backend.get_default_group(),
                      device="cpu")
    step, args = _sparse_case("sgd")
    opt = Sgd(0.05)
    dense_step = model.make_train_step(opt)

    def dense_args():
        p, *batch = args()
        return (p, None, *batch)

    return dense_step, dense_args


def test_mode_filters_and_comm_ops(world1):
    step, args = _sharded_capture(world1)
    et = capture_execution_trace(step, *args())
    comm = [n.name for n in et.comm_nodes()]
    assert comm == ["c10d::alltoall_base_.default"] * 3 + \
        ["c10d::allreduce_.default"] * 3
    full = EtReplayManager(et, inputs=inputs_for(et, *args()), device="cpu")
    out = full.replay(iters=1)
    assert out["errors"] == {}
    for g, w in zip(full.outputs(), tensor_leaves(step(*args()))):
        assert torch.equal(g, w.detach())
    out = EtReplayManager(et, mode=ReplayMode.COMM, device="cpu").replay()
    assert out["num_ops"] == 6 and out["errors"] == {}
    out = EtReplayManager(et, mode="comp", device="cpu").replay()
    assert out["num_ops"] == len(et.compute_nodes()) == \
        len(et.get_nodes()) - 6
    assert out["errors"] == {}
    ops = ct.comms_from_et(et, 1)
    assert [(o.comms, o.world_size) for o in ops] == \
        [("all_to_all", 1)] * 3 + [("all_reduce", 1)] * 3
    # ids (b, T, nnz) int32, then the pooled (B, T, D) and its transpose
    assert [o.in_msg_size for o in ops[:3]] == [64 * 4 * 4, 64 * 4 * 16,
                                                64 * 4 * 16]
    assert ops[0].dtype == "int32" and ops[1].dtype == "float32"


def test_lazy_allocation_frees():
    rng = np.random.default_rng(2)
    x, w = (torch.from_numpy(rng.random(s, dtype=np.float32))
            for s in ((4, 8), (8, 8)))
    et = capture_execution_trace(
        lambda x, w: torch.softmax(torch.relu(x @ w) @ w, -1).sum(), x, w)
    mgr = EtReplayManager(et, alloc=AllocationMode.LAZY, device="cpu")
    out = mgr.replay(iters=1)
    assert out["errors"] == {}
    assert len(mgr.registry) < len(et.tensors)
    assert set(mgr.registry) >= set(et.out_tensors)


def test_skip_config_and_its_update_on_a_failing_node(tmp_path):
    x = torch.ones(4, 8)
    et = capture_execution_trace(lambda x: torch.exp(torch.relu(x)) * 2, x)
    data = et.to_json()
    relu = next(n for n in data["nodes"] if n["name"] == "aten::relu.default")
    relu["name"] = "aten::no_such_op.default"
    bad = ExecutionTrace(data)
    mgr = EtReplayManager(bad, device="cpu")
    out = mgr.replay(iters=1)
    assert list(out["errors"]) == [relu["id"]]
    assert out["num_skipped"] == 1
    assert mgr.config.skip_nodes == {relu["id"]}
    path = str(tmp_path / "skip.json")
    mgr.config.save(path)
    again = EtReplayManager(bad, config=ReplayConfig.load(path), device="cpu")
    out = again.replay(iters=1)
    assert out["errors"] == {} and out["num_skipped"] == 1
    by_name = EtReplayManager(et, config=ReplayConfig(
        skip_names={"aten::exp.default"}), device="cpu").replay()
    assert by_name["num_skipped"] == 1 and by_name["errors"] == {}


def test_npz_inputs_override(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.random((4, 8), dtype=np.float32)
    w = rng.random((8, 8), dtype=np.float32)
    et = capture_execution_trace(lambda x, w: torch.tanh(x @ w),
                                 torch.ones(4, 8), torch.ones(8, 8))
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **{str(et.in_tensors[0]): x, str(et.in_tensors[1]): w})
    mgr = EtReplayManager(et, inputs_file=path, device="cpu")
    mgr.replay(iters=1)
    np.testing.assert_allclose(mgr.outputs()[0].numpy(), np.tanh(x @ w),
                               rtol=1e-6)


def test_multi_iteration_replay_copies_mutated_inputs():
    def step(p, g):
        p.add_(g, alpha=-0.5)
        return p * 2

    p0 = torch.from_numpy(np.random.default_rng(5).random(8, dtype=np.float32))
    g = torch.ones(8)
    et3 = capture_execution_trace(step, p0.clone(), g, iterations=3)
    base = len(capture_execution_trace(step, p0.clone(), g).get_nodes())
    given = (p0.clone(), g.clone())
    mgr = EtReplayManager(et3, inputs=inputs_for(et3, *given), device="cpu")
    out = mgr.replay(iters=3, warmup=1)
    assert out["trace_iterations"] == 3 and out["num_ops"] == 3 * base
    assert len(out["per_iteration_s"]) == 3
    # the three recorded iterations update p three times; every replayed
    # iteration starts again from the given p
    assert torch.equal(mgr.outputs()[0], (p0 - 1.5) * 2)
    assert torch.equal(given[0], p0)
    et1 = capture_execution_trace(step, p0.clone(), g)
    mgr = EtReplayManager(et1, inputs=inputs_for(et1, p0, g), device="cpu")
    mgr.replay(iters=4)
    assert torch.equal(mgr.outputs()[0], (p0 - 0.5) * 2)


def _strings(v, under_device=False):
    if isinstance(v, dict):
        for k, x in v.items():
            yield from _strings(x, k == "__device__")
    elif isinstance(v, list):
        for x in v:
            yield from _strings(x)
    elif isinstance(v, str) and not under_device:
        yield v


def test_cpu_capture_holds_device_markers_not_device_strings():
    fn, args = cli.workload("dlrm_train", "cpu")
    et = capture_execution_trace(fn, *args)
    params = [n.params for n in et.get_nodes()]
    assert not [s for p in params for s in _strings(p) if "cpu" in s]
    text = json.dumps(params)
    assert text.count('"__device__"') >= 3  # arange, tril_indices, ...
    assert '"__dtype__": "int32"' in text


def test_jaxpr_trace_refused_by_the_op_replay():
    et = ExecutionTrace.load(FIXTURES[0])
    with pytest.raises(ValueError, match=JAX_SCHEMA):
        EtReplayManager(et, device="cpu")
    with pytest.raises(ValueError, match=JAX_SCHEMA):
        generate_code(et)


def _run_script(path, *extra):
    return subprocess.run([sys.executable, path, "--device", "cpu", *extra],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))


def test_generated_script_runs_on_cpu(tmp_path):
    fn, args = cli.workload("dlrm", "cpu")
    et = capture_execution_trace(fn, *args)
    code = generate_code(et)
    assert "import param_tpu_torch.kernels" in code
    assert "torch.ops.param_tpu_torch.emb_gather.default(" in code
    path = str(tmp_path / "gen.py")
    with open(path, "w") as f:
        f.write(code)
    r = _run_script(path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"replayed {len(et.get_nodes())} ops OK"


def test_generated_script_of_a_sharded_step_runs_on_gloo(tmp_path, world1):
    step, args = _sharded_capture(world1)
    et = capture_execution_trace(step, *args())
    code = generate_code(et)
    assert "C10D['c10d::alltoall_base_']" in code
    path = str(tmp_path / "gen_sharded.py")
    with open(path, "w") as f:
        f.write(code)
    env_port = str(29000 + os.getpid() % 1000)
    r = subprocess.run([sys.executable, path, "--device", "cpu"],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT,
                                MASTER_PORT=env_port))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"replayed {len(et.get_nodes())} ops OK"


def test_comm_replay_of_a_captured_et_under_mock(tmp_path, world1):
    step, args = _sharded_capture(world1)
    et = capture_execution_trace(step, *args())
    path = str(tmp_path / "sharded_et.json")
    et.save(path)
    backend = MockBackend()
    rep = CommsReplay(backend, ReplayParams(trace_path=path, trace_type="et",
                                            do_warmup=False))
    report = rep.run()
    assert report["num_ops"] == 6
    assert [n for n, _ in backend.calls] == ["all_to_all"] * 3 + \
        ["all_reduce"] * 3


def test_functional_collective_replays_on_the_live_group(world1):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    def f(x):
        return fc.all_reduce(x * 2, "sum", dist.group.WORLD) + 1

    x = torch.arange(6.0)
    et = capture_execution_trace(f, x)
    assert [n.name for n in et.comm_nodes()] == [
        "_c10d_functional::all_reduce.default",
        "_c10d_functional::wait_tensor.default"]
    mgr = EtReplayManager(et, inputs=inputs_for(et, x), device="cpu")
    assert mgr.replay()["errors"] == {}
    assert torch.equal(mgr.outputs()[0], f(x))
    assert [(o.comms, o.in_msg_size) for o in ct.comms_from_et(et, 1)] == \
        [("all_reduce", 6)]
    out = EtReplayManager(et, mode="comm", device="cpu").replay()
    assert out["num_ops"] == 2 and out["errors"] == {}


def _gather(x):
    from param_tpu_torch.models.parallel import gather_from_group

    return gather_from_group(x * 2, _group1()) + 1


def _group1():
    import torch.distributed as dist
    from param_tpu_torch.backend.base import CommGroup

    return CommGroup(ranks=[0], pg=dist.group.WORLD, name="tp")


def _reduce_scatter(x):
    import torch.distributed as dist

    out = torch.empty_like(x)
    dist.reduce_scatter(out, [x * 2])
    return out + 1


def _all_reduce_coalesced(x):
    import torch.distributed as dist

    a, b = x * 2, x * 3
    dist.all_reduce_coalesced([a, b])
    return a + b


LIST_COMMS = {
    "gather_from_group": (_gather, "c10d::allgather_.default", "all_gather",
                          6, 6),
    "reduce_scatter": (_reduce_scatter, "c10d::reduce_scatter_.default",
                       "reduce_scatter", 6, 6),
    "all_reduce_coalesced": (_all_reduce_coalesced,
                             "c10d::allreduce_coalesced_.default",
                             "all_reduce", 12, 12),
}


@pytest.mark.filterwarnings("ignore:`torch.distributed.all_reduce_coalesced`")
@pytest.mark.parametrize("case", sorted(LIST_COMMS))
def test_list_collectives_capture_and_replay(world1, case):
    """The c10d ops of list collectives (``dist.all_gather``, which the
    tp path's ``gather_from_group`` calls, ``reduce_scatter`` and
    ``all_reduce_coalesced``) replay through their ``torch.distributed``
    call; their comm ops count every tensor of their lists."""
    f, node, comms, n_in, n_out = LIST_COMMS[case]
    x = torch.from_numpy(np.random.default_rng(5).random(6, np.float32))
    et = capture_execution_trace(f, x)
    assert [n.name for n in et.comm_nodes()] == [node]
    mgr = EtReplayManager(et, inputs=inputs_for(et, x), device="cpu")
    out = mgr.replay(iters=2)
    assert out["errors"] == {} and out["num_skipped"] == 0
    assert torch.equal(mgr.outputs()[0], f(x))
    assert [(o.comms, o.in_msg_size, o.out_msg_size, o.world_size)
            for o in ct.comms_from_et(et, 1)] == [(comms, n_in, n_out, 1)]
    out = EtReplayManager(et, mode="comm", device="cpu").replay()
    assert out["num_ops"] == 1 and out["errors"] == {}


def test_generated_script_of_list_collectives_runs_on_gloo(tmp_path, world1):
    def f(x):
        return _gather(x) + _reduce_scatter(x)

    x = torch.arange(6.0)
    et = capture_execution_trace(f, x)
    code = generate_code(et)
    assert "def _c10d_allgather(" in code and "C10D['c10d::allgather_']" in code
    path = str(tmp_path / "gen_lists.py")
    with open(path, "w") as fh:
        fh.write(code)
    r = subprocess.run([sys.executable, path, "--device", "cpu"],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT,
                                MASTER_PORT=str(30000 + os.getpid() % 1000)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"replayed {len(et.get_nodes())} ops OK"


def test_a_c10d_op_without_a_replay_call_is_an_error():
    from param_tpu_torch.trace.et_replay import resolve_op

    with pytest.raises(KeyError, match="c10d::gather_"):
        resolve_op("c10d::gather_.default")
    et = ExecutionTrace({"schema": SCHEMA, "nodes": [
        {"id": 1, "name": "c10d::gather_.default", "parent": 0, "op": True,
         "inputs": [], "outputs": [], "params": {"args": []}, "iter": 0}]})
    with pytest.raises(KeyError, match="c10d::gather_"):
        generate_code(et)
    out = EtReplayManager(et, device="cpu").replay()
    assert list(out["errors"]) == [1] and "c10d::gather_" in out["errors"][1]
