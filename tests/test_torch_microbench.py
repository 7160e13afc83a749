"""The port's operator microbench (``param_tpu_torch.microbench``) against
the JAX package's (``param_tpu.microbench``) on the CPU.

The same numpy-seeded inputs go through both; module parameters carry over
from flax (``models/convert``).  Tolerances: f32 outputs rtol 1e-5, atol
1e-6 (matmuls and convolutions: 1e-5 of the largest |output|, long sums in
another order); bf16 outputs two bf16 ulps (rtol 2**-7, atol 2**-7 of the
largest |output|: XLA rounds each bf16 elementwise step, PyTorch computes in
f32 and rounds once); bf16 inputs with f32 outputs (the matmuls' f32 sums of
exact products) 1e-5 of the largest |output|; f32 gradients rtol 1e-5, atol
1e-6 + 1e-5 of the largest |gradient| (softmax's are zero up to rounding).
"""

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import param_tpu.microbench.operator as jop
from param_tpu.microbench import benchmark as jbench
from param_tpu.microbench import data as jdata
from param_tpu.microbench import iterator as jiter
from param_tpu_torch.microbench import benchmark as tbench
from param_tpu_torch.microbench import data as tdata
from param_tpu_torch.microbench import iterator as titer
import param_tpu_torch.microbench.operator as top
from param_tpu_torch.models.convert import (
    batched_embedding_from_jax, flax_params_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["basic_ops.json", "transformer_ops.json", "llama2.json"]

jop.load_workloads()
top.load_workloads()


def _clean_all():
    for reg in (jop.op_map, top.op_map):
        for op in reg.values():
            op.cleanup()


@pytest.fixture(autouse=True)
def _fresh_ops():
    """The registries hold singletons: start and end each test with none
    built (the JAX package's ``BuildableOp.build`` keeps old flax
    parameters otherwise)."""
    _clean_all()
    yield
    _clean_all()


def _np(x):
    """A tensor or array as numpy (bf16 as f32: exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(got, want, dtype=None):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = float(np.max(np.abs(w))) if w.size else 0.0
    if dtype == "bf16":
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=2 ** -7 * scale)
    elif dtype == "sum":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)
    elif dtype == "grad":  # may be exactly zero up to rounding (softmax)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 + 1e-5 * scale)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ expansion
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("iterator", ["RangeConfigIterator",
                                      "DefaultConfigIterator"])
@pytest.mark.parametrize("key", ["build", "input"])
def test_config_expansion_equals_jax(config, iterator, key):
    with open(os.path.join(ROOT, "configs", config)) as f:
        raw = json.load(f)
    for name, spec in raw.items():
        if name.startswith("_"):
            continue
        cfgs = spec.get("config", [])
        want = list(jiter.get_config_iterator(iterator)(cfgs, key=key))
        got = list(titer.get_config_iterator(iterator)(cfgs, key=key))
        assert got == want, name


def test_generators_are_the_jax_expansion():
    from param_tpu.microbench import generator as jg
    from param_tpu_torch.microbench import generator as tg

    assert list(tg.full_range(1, 9, 3)) == list(jg.full_range(1, 9, 3))
    t = tg.ListProduct([tg.IterableList([1, 2]), 7,
                        tg.TableProduct({"a": tg.IterableList([3, 4])})])
    j = jg.ListProduct([jg.IterableList([1, 2]), 7,
                        jg.TableProduct({"a": jg.IterableList([3, 4])})])
    assert list(t) == list(j)


# ------------------------------------------------------------ data
@pytest.mark.parametrize("spec", [
    {"type": "tensor", "dtype": "float32", "shape": [7, 33]},
    {"type": "tensor", "dtype": "bfloat16", "shape": [5, 64]},
    {"type": "tensor", "dtype": "float16", "shape": [3, 9]},
    {"type": "tensor", "dtype": "int32", "shape": [100], "low": 5, "high": 1000},
    {"type": "tensor", "dtype": "bool", "shape": [4, 4]},
    {"type": "tensor", "dtype": "float32", "shape": []},
], ids=["f32", "bf16", "f16", "int32", "bool", "scalar_tensor"])
def test_materialize_tensor_bitwise(spec):
    want = np.asarray(jdata.materialize_arg(spec, np.random.default_rng(3)))
    got = tdata.materialize_arg(spec, np.random.default_rng(3), "cpu")
    assert tuple(got.shape) == want.shape
    if spec["dtype"] in ("bfloat16", "float16"):
        bits = got.view(torch.int16).numpy()
        np.testing.assert_array_equal(bits, want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", [
    {"type": "int", "value": 7}, {"type": "long", "value": 3},
    {"type": "float", "value": 1.5}, {"type": "double", "value": 2.0},
    {"type": "bool", "value": True}, {"type": "str", "value": "x"},
    {"type": "none"},
    {"type": "genericlist", "value": [{"type": "int", "value": 1},
                                      {"type": "float", "value": 2.5}]},
    {"type": "tuple", "value": [{"type": "int", "value": 4},
                                {"type": "bool", "value": False}]},
], ids=lambda s: s["type"])
def test_materialize_scalars_and_lists(spec):
    want = jdata.materialize_arg(spec, np.random.default_rng(0))
    got = tdata.materialize_arg(spec, np.random.default_rng(0), "cpu")
    assert got == want and type(got) is type(want)


def test_materialize_lists_of_tensors_and_device():
    spec = {"type": "genericlist", "value": [
        {"type": "tensor", "dtype": "float32", "shape": [2, 3]},
        {"type": "tensor", "dtype": "int32", "shape": [4]}]}
    want = jdata.materialize_arg(spec, np.random.default_rng(1))
    got = tdata.materialize_arg(spec, np.random.default_rng(1), "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the device spec defaults to the run's device
    assert tdata.materialize_arg({"type": "device"}, None, "cpu") == "cpu"
    with pytest.raises(ValueError):
        tdata.materialize_arg({"type": "quantum"}, np.random.default_rng(0),
                              "cpu")


def test_generator_names_registered():
    for name in ("DefaultDataGenerator", "PyTorch:DefaultDataGenerator",
                 "JAX:DefaultDataGenerator"):
        assert tdata.get_data_generator(name) is tdata.DefaultDataGenerator


# ------------------------------------------------------------ ops
def _t(shape, dtype="float32", **kw):
    return {"type": "tensor", "dtype": dtype, "shape": shape, **kw}


def _fresh_bag_op():
    from param_tpu_torch.microbench.workloads.batched_embedding import (
        BatchedEmbeddingOp,
    )
    return BatchedEmbeddingOp()


def _built_bag_device():
    op = _fresh_bag_op()
    op.build(1, 4, 2)
    return op.tables.device


@pytest.mark.parametrize("make", [
    lambda: tdata.materialize_arg(_t([2]), np.random.default_rng(0)).device,
    lambda: tdata.DefaultDataGenerator().device,
    lambda: _fresh_bag_op().device,
    _built_bag_device,
], ids=["materialize_arg", "DefaultDataGenerator", "op.device", "op.build"])
def test_defaults_are_the_card(make):
    """Named no device, the tier's pieces take the card; without one they
    refuse (``resolve_device``) instead of running on the host."""
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def _v(kind, value):
    return {"type": kind, "value": value}


# name -> (build arg specs, input arg specs, input kwarg specs, tolerance)
OPS = {
    "jnp.add": ([], [_t([4, 6]), _t([4, 6])], {}, None),
    "jnp.mul": ([], [_t([4, 6]), _t([6])], {}, None),
    "jnp.clamp": ([], [_t([5, 7]), _v("float", 0.25), _v("float", 0.75)],
                  {}, None),
    "jnp.matmul": ([], [_t([16, 32]), _t([32, 8])], {}, "sum"),
    "jnp.mm": ([], [_t([16, 32], "bfloat16"), _t([32, 8], "bfloat16")], {},
               "sum"),
    "jnp.bmm": ([], [_t([3, 16, 32], "bfloat16"), _t([3, 32, 8], "bfloat16")],
                {}, "sum"),
    "jnp.relu": ([], [_t([9, 5])], {}, None),
    "jnp.gelu": ([], [_t([64, 32], "bfloat16")], {}, "bf16"),
    "jnp.softmax": ([], [_t([4, 8, 16])], {}, None),
    "nn.sdpa": ([], [_t([2, 16, 4, 8]), _t([2, 16, 4, 8]), _t([2, 16, 4, 8])],
                {}, "sum"),
    "jnp.reshape": ([], [_t([4, 6]), {"type": "tuple", "value": [
        _v("int", 3), _v("int", 8)]}], {}, None),
    "nn.Linear": ([_v("int", 12), _v("int", 5)], [_t([7, 12])], {}, "sum"),
    "nn.Conv2d": ([_v("int", 3), _v("int", 4), _v("int", 3), _v("int", 2)],
                  [_t([2, 8, 8, 3])], {}, "sum"),
    "jnp.baddbmm": ([], [_t([2, 4, 5]), _t([2, 4, 3]), _t([2, 3, 5])], {},
                    "sum"),
    "jnp.cat": ([], [{"type": "genericlist", "value": [_t([2, 3]), _t([4, 3])]}],
                {}, None),
    "jnp.mean": ([], [_t([6, 10])], {}, None),
    "nn.MaxPool2d": ([_v("int", 3), _v("int", 2), _v("int", 1)],
                     [_t([2, 9, 9, 3])], {}, None),
    "nn.AdaptiveAvgPool2d": ([_v("int", 2)], [_t([2, 8, 8, 3])], {}, None),
    "nn.ReLU": ([], [_t([5, 5])], {}, None),
}
ALIASES = {"jnp.add_": "jnp.add", "jnp.clamp_": "jnp.clamp",
           "torch.add": "jnp.add", "torch.add_": "jnp.add",
           "torch.clamp_": "jnp.clamp", "torch.baddbmm": "jnp.baddbmm",
           "torch.cat": "jnp.cat", "torch.mean": "jnp.mean",
           "torch.mul": "jnp.mul", "torch.reshape": "jnp.reshape",
           "torch.matmul": "jnp.matmul", "torch.mm": "jnp.mm",
           "torch.bmm": "jnp.bmm", "torch.nn.functional.relu": "jnp.relu",
           "torch.nn.Linear": "nn.Linear", "torch.nn.Conv2d": "nn.Conv2d",
           "torch.nn.MaxPool2d": "nn.MaxPool2d",
           "torch.nn.AdaptiveAvgPool2d": "nn.AdaptiveAvgPool2d",
           "torch.nn.ReLU": "nn.ReLU"}
DROPOUT = ("nn.Dropout", "torch.nn.Dropout")


def test_every_registered_basic_op_is_covered():
    src = open(os.path.join(ROOT, "param_tpu", "microbench", "workloads",
                            "basic_ops.py")).read()
    names = {n for n in jop.op_map if f'"{n}"' in src}
    assert names == set(OPS) | set(ALIASES) | set(DROPOUT)
    assert names <= set(top.op_map)


def _run_pair(name, spec_name=None, seed=0):
    """(port output, JAX output) of op ``name`` on the same inputs, flax
    parameters carried over for buildable modules."""
    b_specs, a_specs, kw_specs, tol = OPS[spec_name or name]
    jo, to = jop.get_operator(name), top.get_operator(name)
    jargs = [jdata.materialize_arg(s, np.random.default_rng(seed))
             for s in b_specs]
    targs = [tdata.materialize_arg(s, np.random.default_rng(seed), "cpu")
             for s in b_specs]
    jo.build(*jargs)
    to.device = torch.device("cpu")
    to.build(*targs)
    rj, rt = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    ja = [jdata.materialize_arg(s, rj) for s in a_specs]
    jk = {k: jdata.materialize_arg(s, rj) for k, s in kw_specs.items()}
    ta = [tdata.materialize_arg(s, rt, "cpu") for s in a_specs]
    tk = {k: tdata.materialize_arg(s, rt, "cpu")
          for k, s in kw_specs.items()}
    want = jo.forward(*ja, **jk)
    if isinstance(to, top.BuildableOp) and isinstance(to.obj, torch.nn.Module):
        flax_params_from_jax(jax.tree.map(np.asarray, jo._params), to.obj,
                             "cpu")
    got = to.forward(*ta, **tk)
    return got, want, tol, (ja, ta)


@pytest.mark.parametrize("name", sorted(OPS) + sorted(ALIASES))
def test_op_forward_matches_jax(name):
    got, want, tol, _ = _run_pair(name, ALIASES.get(name))
    _close(got, want, tol)
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)


@pytest.mark.parametrize("case", [
    ("jnp.gelu", [_t([17, 9])], None),
    ("jnp.mm", [_t([64, 128], "bfloat16"), _t([128, 48], "bfloat16")], "sum"),
    ("jnp.matmul", [_t([3, 64, 32], "bfloat16"), _t([1, 32, 16], "bfloat16")],
     "sum"),
    ("jnp.bmm", [_t([4, 32, 64], "bfloat16"), _t([4, 64, 16], "bfloat16")],
     "sum"),
    ("jnp.baddbmm", [_t([2, 8, 4], "bfloat16"), _t([2, 8, 16], "bfloat16"),
                     _t([2, 16, 4], "bfloat16")], "bf16"),
    ("jnp.softmax", [_t([4, 33], "bfloat16")], "bf16"),
    ("jnp.mean", [_t([8, 8], "int32", high=100)], None),
    ("nn.sdpa", [_t([1, 8, 4, 16]), _t([1, 8, 2, 16]), _t([1, 8, 2, 16])],
     "sum"),
], ids=["gelu_f32", "mm_bf16_f32_out", "matmul_broadcast_bf16",
        "bmm_bf16_f32_out", "baddbmm_bf16", "softmax_bf16", "mean_int",
        "sdpa_gqa"])
def test_op_traps(case):
    """gelu's tanh approximation, f32 sums of bf16 products, the broadcast
    matmul of transformer_ops, baddbmm's cast back, int mean, GQA."""
    name, specs, tol = case
    OPS["_case"] = ([], specs, {}, tol)
    try:
        got, want, tol, _ = _run_pair(name, "_case")
    finally:
        del OPS["_case"]
    _close(got, want, tol)
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)


@pytest.mark.parametrize("kw", [
    dict(is_causal=True), dict(scale=0.3),
    dict(mask=np.tril(np.ones((6, 6), bool))),
    dict(bias=np.random.default_rng(4).standard_normal((1, 2, 6, 6)).astype(
        np.float32)),
    dict(bias=np.full((1, 2, 6, 6), 0.5, np.float32),
         mask=np.triu(np.ones((6, 6), bool))),
], ids=["causal", "scale", "mask", "bias", "bias_and_mask"])
def test_sdpa_options_match_jax(kw):
    """``nn.sdpa``'s bias, mask, scale and is_causal as
    ``jax.nn.dot_product_attention`` takes them."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    want = jop.get_operator("nn.sdpa").forward(*map(jnp.asarray, (q, k, v)),
                                               **jkw)
    got = top.get_operator("nn.sdpa").forward(*map(torch.from_numpy,
                                                   (q, k, v)), **tkw)
    _close(got, want, "sum")


@pytest.mark.parametrize("build,shape", [
    ((3, 4, 3, 2), [2, 8, 8, 3]),    # SAME, stride 2: pads (0, 1)
    ((3, 4, 4, 1), [1, 7, 6, 3]),    # SAME, even kernel: pads (1, 2)
    ((2, 5, 5, 3), [2, 11, 10, 2]),  # SAME, stride 3
], ids=["s2_asym", "k4_asym", "s3"])
def test_same_padded_conv_matches_flax(build, shape):
    OPS["_conv"] = ([_v("int", b) for b in build], [_t(shape)], {}, "sum")
    try:
        got, want, tol, _ = _run_pair("nn.Conv2d", "_conv")
    finally:
        del OPS["_conv"]
    _close(got, want, tol)


@pytest.mark.parametrize("build,shape", [
    ((2, None, 0), [2, 8, 8, 3]), ((3, 2, 1), [1, 10, 7, 2]),
    ((3, 1, 1), [1, 5, 5, 1])])
def test_maxpool_pads_with_minus_inf(build, shape):
    k, s, p = build
    OPS["_pool"] = ([_v("int", k)] + ([_v("int", s)] if s else [])
                    + ([_v("int", p)] if p else []), [_t(shape)], {}, None)
    try:
        got, want, tol, (ja, ta) = _run_pair("nn.MaxPool2d", "_pool")
        # all-negative input: a zero pad would show
        jo, to = jop.get_operator("nn.MaxPool2d"), top.get_operator(
            "nn.MaxPool2d")
        _close(to.forward(-1 - ta[0]), jo.forward(-1 - ja[0]))
    finally:
        del OPS["_pool"]
    _close(got, want, tol)


@pytest.mark.parametrize("out,shape", [(2, [2, 8, 8, 3]), (4, [1, 8, 12, 2]),
                                       (1, [2, 5, 5, 3])])
def test_adaptive_avgpool_matches_jax(out, shape):
    OPS["_ap"] = ([_v("int", out)], [_t(shape)], {}, None)
    try:
        got, want, tol, _ = _run_pair("nn.AdaptiveAvgPool2d", "_ap")
    finally:
        del OPS["_ap"]
    _close(got, want, tol)


@pytest.mark.parametrize("name", DROPOUT)
def test_dropout_holds_by_structure(name):
    op = top.get_operator(name)
    op.device = torch.device("cpu")
    p = 0.3
    op.build(p)
    x = torch.rand(200, 500) + 0.5
    y = op.forward(x)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - p))
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    assert torch.equal(op.forward(x), y)  # the same mask every call
    assert y.dtype == x.dtype


# ------------------------------------------------------------ models
def _model_pair(name, shape, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    jo, to = jop.get_operator(name), top.get_operator(name)
    jo.build()
    want = jo.forward(jnp.asarray(x))
    to.device = torch.device("cpu")
    to.build()
    xt = torch.from_numpy(x)
    to.forward(xt)  # builds the module for this shape
    flax_params_from_jax(jax.tree.map(np.asarray, jo.params), to.model, "cpu")
    return to.forward(xt), want


@pytest.mark.parametrize("name,shape", [("AlexNet", (2, 64, 64, 3)),
                                        ("ResNetSmall", (2, 16, 16, 3))])
def test_convnets_match_flax(name, shape):
    got, want = _model_pair(name, shape)
    _close(got, want, "sum")
    assert tuple(got.shape) == (shape[0], 1000)


def test_convnet_parameter_names_are_flax_names():
    _model_pair("ResNetSmall", (1, 8, 8, 3))
    jo, to = jop.get_operator("ResNetSmall"), top.get_operator("ResNetSmall")
    flat = jax.tree_util.tree_flatten_with_path(jo.params["params"])[0]
    jnames = sorted(".".join(p.key for p in path).replace(
        "kernel", "weight") for path, _ in flat)
    assert jnames == sorted(n for n, _ in to.model.named_parameters())


@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_batched_embedding_matches_jax(pooling):
    jo = jop.get_operator("BatchedEmbedding")
    to = top.get_operator("SplitTableBatchedEmbeddingBagsCodegen")
    jo.build(3, 50, 8, pooling)
    to.device = torch.device("cpu")
    to.build(3, 50, 8, pooling)
    assert tuple(to.tables.shape) == (3, 50, 8)
    assert to.tables.dtype == torch.float32
    batched_embedding_from_jax(to, np.asarray(jo.tables), "cpu")
    spec = _t([6, 3, 4], "int32", low=0, high=50)
    ids_j = jdata.materialize_arg(spec, np.random.default_rng(2))
    ids_t = tdata.materialize_arg(spec, np.random.default_rng(2), "cpu")
    _close(to.forward(ids_t), jo.forward(ids_j), "sum")


# ------------------------------------------------------------ backward
@pytest.mark.parametrize("name", ["jnp.add", "jnp.matmul", "jnp.gelu",
                                  "jnp.softmax", "nn.Linear", "nn.Conv2d",
                                  "jnp.baddbmm", "nn.sdpa", "jnp.mean"])
def test_backward_matches_jax_grad(name):
    """The backward pass's gradients (of sum(f32(out)) with respect to the
    float tensor args) against ``jax.grad`` of the same loss."""
    got, want, tol, (ja, ta) = _run_pair(name)
    jo, to = jop.get_operator(name), top.get_operator(name)
    ft = [i for i, a in enumerate(ta)
          if isinstance(a, torch.Tensor) and a.is_floating_point()]

    def jloss(*inner):
        full = list(ja)
        for i, v in zip(ft, inner):
            full[i] = v
        return jnp.sum(jo.forward(*full).astype(jnp.float32))

    jg = jax.grad(jloss, argnums=tuple(range(len(ft))))(*[ja[i] for i in ft])
    full = list(ta)
    for i in ft:
        full[i] = ta[i].detach().requires_grad_(True)
    tg = torch.autograd.grad(to.forward(*full).float().sum(),
                             [full[i] for i in ft])
    for g, w in zip(tg, jg):
        _close(g, w, "bf16" if g.dtype == torch.bfloat16 else "grad")


# ------------------------------------------------------------ records
def _records(pkg_bench, options, config):
    cfg = pkg_bench.BenchmarkConfig.load_json_file(
        os.path.join(ROOT, "configs", config))
    stream = io.StringIO()
    options.out_stream = stream
    res = pkg_bench.Benchmark(cfg, options).run()
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert lines == json.loads(json.dumps(res))
    return lines


def _shape_of(rec):
    return {k: (sorted(v) if isinstance(v, dict) else v)
            for k, v in rec.items() if k not in ("forward", "backward")}


@pytest.mark.parametrize("mode", ["chain", "discrete"])
def test_basic_ops_records_match_jax(mode):
    opts = dict(iters=2, passes="forward,backward", mode=mode)
    want = _records(jbench, jbench.RunOptions(**opts), "basic_ops.json")
    got = _records(tbench, tbench.RunOptions(device="cpu", **opts),
                   "basic_ops.json")
    assert [r["run_id"] for r in got] == [r["run_id"] for r in want]
    assert [r["config"] for r in got] == [r["config"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for p in ("forward", "backward"):
            assert set(g[p]) == set(w[p]), (g["run_id"], p, g[p], w[p])
            if "error" in w[p]:
                assert g[p] == w[p]
            else:
                lat = g[p]["lat_us" if mode == "chain" else "lat_us_p50"]
                assert np.isfinite(lat) and lat > 0


RANGE_CFG = {"jnp.add": {"config": [{"input": [{"args": [
    _t([8, [8, 11, 1], 1], __range__=["shape"]),
    _t([8, 8, 1], __copy__=[{"shape": [1, [0, 1]]}])]}]}]},
    "jnp.relu": {"config": [{"input": [{"args": [_t([4, 4])]}]}]}}


@pytest.mark.parametrize("resume,stop", [(None, "jnp.add:0:1"),
                                         ("jnp.add:0:2", None),
                                         ("jnp.add:0:1", "jnp.add:0:2"),
                                         ("jnp.add:0:3", "jnp.relu:0:0")])
def test_resume_and_stop_match_jax(resume, stop):
    def ids(pkg, **kw):
        res = pkg.Benchmark(pkg.BenchmarkConfig(RANGE_CFG), pkg.RunOptions(
            iters=1, resume_op_run_id=resume, stop_op_run_id=stop, **kw)).run()
        return [r["run_id"] for r in res]

    assert ids(tbench, device="cpu") == ids(jbench)
    assert ids(tbench, device="cpu")  # not empty


def test_profile_dir_records_device_ops(tmp_path):
    cfg = tbench.BenchmarkConfig(RANGE_CFG)
    res = tbench.Benchmark(cfg, tbench.RunOptions(
        iters=1, device="cpu", passes="forward,backward",
        profile_dir=str(tmp_path), stop_op_run_id="jnp.add:0:0")).run()
    for p in ("forward", "backward"):
        prof = res[0][p]["profile"]
        assert "error" not in prof, prof
        assert os.path.isfile(os.path.join(prof["dir"], "trace.json"))
        assert prof["device_ops"] and all(d["total_us"] >= 0
                                          for d in prof["device_ops"])
    assert res[0]["forward"]["profile"]["dir"] != \
        res[0]["backward"]["profile"]["dir"]


def test_benchmark_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.Benchmark(tbench.BenchmarkConfig(RANGE_CFG), tbench.RunOptions())


# ------------------------------------------------------------ CLI, registry
def _list_ops(module):
    r = subprocess.run([sys.executable, "-m", module, "--list-ops",
                        "--log", "ERROR"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_list_ops_lists_the_jax_names():
    assert _list_ops("param_tpu_torch.cli.run_benchmark") == \
        _list_ops("param_tpu.cli.run_benchmark")


def test_cli_writes_jsonl_and_prints(tmp_path, capsys):
    from param_tpu_torch.cli import run_benchmark

    out = tmp_path / "r.jsonl"
    assert run_benchmark.main(["-c", os.path.join(ROOT, "configs",
                                                  "basic_ops.json"),
                               "-o", str(out), "-b", "-i", "2",
                               "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["run_id"] for r in recs] == [
        "jnp.add:0:0", "jnp.add:0:1", "jnp.matmul:0:0", "nn.Linear:0:0",
        "BatchedEmbedding:0:0"]
    assert capsys.readouterr().out.count("'run_id'") == 5
    assert run_benchmark.main(["-c", os.path.join(ROOT, "configs",
                                                  "basic_ops.json"),
                               "-o", str(out), "-a", "-i", "1",
                               "--stop-op-run-id", "jnp.add:0:0",
                               "--device", "cpu"]) == 0
    assert len(out.read_text().splitlines()) == 6
    assert run_benchmark.main([]) == 2


def test_torch_paths_auto_wrap_and_unknown_names_raise():
    op = top.get_operator("torch.tanh")
    assert isinstance(op, top.TorchPathOp)
    assert op.forward(torch.zeros(3)).abs().max().item() == 0.0
    op = top.get_operator("torch.nn.functional.silu")
    torch.testing.assert_close(op.forward(torch.ones(2)),
                               torch.nn.functional.silu(torch.ones(2)))
    for name in ("definitely.not.registered", "jax.numpy.tanh", "jnp.tanh",
                 "torch.not_a_function"):
        with pytest.raises(ValueError):
            top.get_operator(name)
    top.register_operator("test.mult2", top.CallableOp(lambda x: x * 2))
    assert top.get_operator("test.mult2") is top.op_map["test.mult2"]
