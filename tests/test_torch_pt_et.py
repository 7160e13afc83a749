"""The port's op-level PyTorch-ET replay (``param_tpu_torch.trace.
pytorch_op_replay``, ``cli.pt_et``) against the JAX package's, on the CPU.

Parity is held in lockstep: both replays run the same trace node by node;
after each node, every tensor it registered (keyed by tensor id) is held
to the JAX value, and the port then continues from the JAX values, so an
op's error is its own and not its inputs' (random activations through a
softmax over scores of 1e3-1e7 amplify a last-bit difference without
bound).  Materialized inputs are held bitwise.  At the end both registries
hold the same keys with the same shapes and dtypes (the JAX package's,
which has no 64-bit types on the CPU: int64 compares as int32), and the
reports the same selected, executed and skipped ops and per-op counts.

Tolerances, of each tensor's largest |value| ("scale"): f32 1e-4 (atol
1e-5); bf16 2e-2, plus the JAX value's own distance from the port's impl
evaluated in f64 on the same inputs (XLA's CPU sums bf16 in bf16: on a
cancelling reduction the JAX value is the one further from the exact
result).

Traces: small torch programs recorded here with ``ExecutionTraceObserver``
(conv / batch-norm / max-pool / cross-entropy / SGD; layer-norm / GELU /
embedding / softmax / Adam's foreach ops; dropout / NLL / log-softmax;
cat / split / chunk / slice / select / index / index_put / cumsum / where /
as_strided; and every other aten op of the table called directly),
hand-built one-node traces for the ops no CPU program can record (fbgemm,
cuDNN, CUDA streams and pinned memory, a PT2 triton kernel), and the
``transformer_train_et`` fixture whole, with fuse None / attention /
attention-train, in f32 and bf16 (the fused windows run in Pallas
interpret mode on the JAX side).  Chain mode, codegen (in a subprocess),
``mode="full"`` on a gloo world of one, the skip config and the
torch-matching backward checks of ``tests/test_pytorch_op_replay.py``
have their counterparts here.  Inputs are made from seeds with numpy.
"""

import dataclasses
import gzip
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ExecutionTraceObserver

from param_tpu.trace import pytorch_op_replay as ref
from param_tpu_torch.trace import pytorch_op_replay as port
from param_tpu_torch.trace.pytorch_et import tensor_key
from param_tpu_torch.trace.pytorch_op_replay import (
    _ATEN, PyTorchOpReplay, UnsupportedOp, supported_aten_ops,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
A = torch.ops.aten


# ------------------------------------------------------------- comparison
def _np(x):
    """A JAX or torch value as a numpy array (bf16 through f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _jax_dtype(t: torch.Tensor):
    """The JAX dtype a port tensor's dtype stands for on the CPU."""
    if t.dtype == torch.bfloat16:
        return jnp.dtype(jnp.bfloat16)
    return jax.dtypes.canonicalize_dtype(
        np.dtype(str(t.dtype).replace("torch.", "")))


def _to_port(jval, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(jval))).to(like.dtype)


def _out_keys(node, window=None):
    keys = []
    for v, t in zip(node.outputs, node.output_types):
        if port.is_tensor_slot(t):
            keys.append(tensor_key(v))
        elif port.is_tensor_list_slot(t):
            keys += [tensor_key(d) for d in v]
    if window is not None and hasattr(window, "outs"):
        keys += [tensor_key(o[1]) for o in window.outs]
    return {k for k in keys if k is not None}


def _lse_key(k):
    """The synthesized lse of a backward window: the JAX package's is
    (B*H, S_q, 128), the port's (B, H, S_q) (the 128-lane layout is a
    TPU leave-out), so it is not compared."""
    return k[0] >= 1_000_000_000 and k[0] % 2 == 1


def _f64_outputs(r, node):
    """The port's impl of ``node`` on its resolved inputs in f64."""
    if node.name not in _ATEN or node.id in r._fused_skip:
        return {}
    args = r._resolve_args(node)

    def up(a):
        if isinstance(a, list):
            return [up(x) for x in a]
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.double()
        return a

    try:
        outs = _ATEN[node.name]([up(a) for a in args], r._meta(node))
    except (UnsupportedOp, RuntimeError, TypeError, ValueError):
        return {}
    got = {}
    for j, (v, t) in enumerate(zip(node.outputs, node.output_types)):
        if j >= len(outs):
            break
        if port.is_tensor_slot(t) and outs[j] is not None:
            got[tensor_key(v)] = outs[j]
        elif port.is_tensor_list_slot(t) and isinstance(outs[j], list):
            got.update({tensor_key(d): o for d, o in zip(v, outs[j])})
    return got


def _check(k, jv, pv, bf16, ref64, where):
    a, b = _np(jv).astype(np.float64), _np(pv).astype(np.float64)
    assert a.shape == b.shape, (where, k, a.shape, b.shape)
    assert _jax_dtype(pv) == jnp.asarray(jv).dtype, (where, k, pv.dtype)
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b)), (where, k)
    assert np.array_equal(a[~fin], b[~fin], equal_nan=True), (where, k)
    if not fin.any():
        return
    scale = float(np.abs(a[fin]).max())
    err = float(np.abs(a[fin] - b[fin]).max())
    if bf16:
        own = 0.0
        if ref64 is not None:
            c = _np(ref64).astype(np.float64)
            if c.shape == a.shape and np.isfinite(c[fin]).all():
                own = float(np.abs(a[fin] - c[fin]).max())
        tol = 2e-2 * scale + 1e-5 + own
    else:
        tol = 1e-4 * scale + 1e-5
    assert err <= tol, (where, k, err, tol, scale)


def lockstep(data, cast=None, **kw):
    """Replay ``data`` in both packages node by node (see the module
    docstring); returns (JAX replay, port replay, JAX report, port
    report)."""
    jr = ref.PyTorchOpReplay(data, cast=cast, **kw)
    pr = PyTorchOpReplay(data, cast=cast, device="cpu", **kw)
    assert [n.id for n in pr.nodes] == [n.id for n in jr.nodes]
    bf16 = cast is not None
    done = [0, 0]
    for node in jr.nodes:
        before = dict(jr.registry)
        ref64 = _f64_outputs(pr, node) if bf16 else {}
        got_j = jr.run_node(node, timed=False)
        got_p = pr.run_node(node, timed=False)
        assert (got_j is None) == (got_p is None), (node.id, node.name,
                                                    jr.skipped, pr.skipped)
        done[0] += got_j is not None
        done[1] += got_p is not None
        outs = _out_keys(node, pr._fused_emit.get(node.id))
        changed = [k for k, v in jr.registry.items()
                   if before.get(k) is not v]
        assert set(changed) <= set(pr.registry), (node.name, changed)
        for k in changed:
            where = f"node {node.id} {node.name}"
            jv, pv = jr.registry[k], pr.registry[k]
            if jv is None or pv is None:
                assert jv is None and pv is None, (where, k)
                continue
            if _lse_key(k):
                continue
            if k in outs:
                _check(k, jv, pv, bf16, ref64.get(k), where)
                pr.registry[k] = _to_port(jv, pv)  # the next node's input
            else:  # materialized: bit for bit
                assert _jax_dtype(pv) == jnp.asarray(jv).dtype, (where, k)
                assert np.array_equal(_np(jv), _np(pv)), (where, k)
    assert set(pr.registry) == set(jr.registry)
    for k, jv in jr.registry.items():
        pv = pr.registry[k]
        if jv is None or _lse_key(k):
            continue
        assert tuple(pv.shape) == tuple(jnp.shape(jv)), k
        assert _jax_dtype(pv) == jnp.asarray(jv).dtype, k
    jrep = jr.report(done[0], 0.0, 1)
    prep = pr.report(done[1], 0.0, 1)
    for key in ("num_selected", "num_executed", "num_skipped_names",
                "shrunk_tensors", "fused_attention_windows"):
        assert prep[key] == jrep[key], key
    assert set(prep["skipped"]) == set(jrep["skipped"])
    assert {k: v["count"] for k, v in prep["per_op"].items()} == \
        {k: v["count"] for k, v in jrep["per_op"].items()}
    return jr, pr, jrep, prep


# ------------------------------------------------------ recorded programs
def record(run):
    """An ExecutionTraceObserver trace of one call of ``run`` (after an
    unobserved warm-up call)."""
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        path = f.name
    obs = ExecutionTraceObserver()
    obs.register_callback(path)
    try:
        run()
        obs.start()
        run()
        obs.stop()
    finally:
        obs.unregister_callback()
    with open(path) as f:
        data = json.load(f)
    os.unlink(path)
    return data


def conv_step():
    torch.manual_seed(0)
    m = torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.BatchNorm2d(4),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2), torch.nn.Flatten(),
        torch.nn.Linear(64, 5))
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    x, y = torch.randn(2, 3, 8, 8), torch.tensor([1, 3])

    def run():
        opt.zero_grad()
        F.cross_entropy(m(x), y).backward()
        opt.step()
    return run


def lm_adam_step():
    torch.manual_seed(0)
    emb, ln = torch.nn.Embedding(10, 8), torch.nn.LayerNorm(8)
    lin = torch.nn.Linear(8, 8)
    params = [*emb.parameters(), *ln.parameters(), *lin.parameters()]
    opt = torch.optim.Adam(params, lr=1e-3, foreach=True)
    ids = torch.tensor([[1, 2, 3], [4, 5, 6]])

    def run():
        opt.zero_grad()
        h = F.gelu(lin(ln(emb(ids))))
        (torch.softmax(h, dim=-1) * h).sum().backward()
        opt.step()
    return run


def dropout_nll():
    torch.manual_seed(0)
    lin = torch.nn.Linear(6, 4)
    x, y = torch.randn(5, 6), torch.tensor([0, 1, 2, 3, 1])

    def run():
        h = F.dropout(lin(x), p=0.5, training=True)
        F.nll_loss(F.log_softmax(h, dim=-1), y).backward()
    return run


def indexing():
    x, idx = torch.randn(4, 6), torch.tensor([0, 2])

    def run():
        a = torch.cat([x, x], dim=0)
        return (torch.split(a, [3, 5], dim=0), torch.chunk(x, 3, dim=1),
                x[1:3, ::2], x.select(0, 1), x[idx],
                x.index_put((idx,), torch.ones(2, 6), accumulate=True),
                torch.cumsum(x, 1), torch.where(x > 0, x, torch.zeros_like(x)),
                torch.as_strided(x, (2, 3), (6, 1), 2))
    return run


def direct_aten():
    """The table's remaining aten ops, each called directly (a top-level
    node of its own)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.rand(*shape, generator=g)

    x, w, b = r(2, 3, 4, 4), r(4, 3, 3, 3), r(4)
    m, v, bm, bv, t = r(4, 6), r(6, 5), r(2, 4, 6), r(2, 6, 5), r(3, 4)
    c, s, u = r(4, 5), r(2, 4, 5), r(3, 4)
    idx, cls = torch.tensor([0, 2]), torch.tensor([1, 0, 3])
    keep, flat = torch.ones(3, 4, dtype=torch.bool), r(36)
    g2, g3 = r(2, 3), r(3, 2)

    def run():
        t2 = t.clone()
        lp = torch.log_softmax(t, 1)
        ap = A._adaptive_avg_pool2d.default(x, [2, 2])
        return [
            A._convolution.default(x, w, b, [1, 1], [1, 1], [1, 1], False,
                                   [0, 0], 1, False, False, True, True),
            A.convolution.default(x, w, b, [1, 1], [0, 0], [1, 1], False,
                                  [0, 0], 1),
            A.native_batch_norm.default(x, torch.ones(3), torch.zeros(3),
                                        None, None, True, 0.1, 1e-5),
            A.adaptive_avg_pool2d.default(x, [2, 2]),
            A._adaptive_avg_pool2d_backward.default(torch.ones_like(ap), x),
            A.max_pool2d_with_indices.default(x, [2, 2], [2, 2]),
            A.addmm.default(c, m, v), A.baddbmm.default(s, bm, bv),
            A.bmm.default(bm, bv), A.matmul.default(m, v),
            A.binary_cross_entropy_with_logits.default(t, u),
            A.clamp_min.default(t, 0.3), A.clamp_min_.default(t.clone(), 0.3),
            A.sigmoid.default(t), A.silu.default(t),
            A.silu_.default(t.clone()), A.tanh.default(t),
            A.tanh_backward.default(t, u), A.relu_.default(t - 0.5),
            A.gelu_.default(t.clone()), A.neg.default(t),
            A.rsqrt.default(t + 1), A.sqrt.default(t),
            A.sqrt_.default(t.clone()), A.pow.Tensor_Scalar(t, 2),
            A.add.Tensor(t, t, alpha=2), A.sub.Tensor(t, 1.5),
            A.sub_.Tensor(t2, u), A.mul_.Tensor(t.clone(), 3.0),
            A.div.Tensor(t, u + 1), A.div_.Scalar(t.clone(), 2.0),
            A.addcmul.default(t, t, u, value=0.5),
            A.addcmul_.default(t.clone(), t, u),
            A.addcdiv.default(t, t, u + 1, value=0.5),
            A.addcdiv_.default(t.clone(), t, u + 1),
            A._softmax.default(t, 1, False),
            A._log_softmax.default(t, 1, False),
            A.mean.dim(t, [1], True), A.mean.default(t),
            A.nll_loss_forward.default(lp, cls, None, 1, -100),
            A.native_layer_norm.default(t, [4], torch.ones(4),
                                        torch.zeros(4), 1e-5),
            A.native_dropout.default(t, 0.5, True),
            A.native_dropout_backward.default(t, keep, 2.0),
            A.dropout_.default(t.clone(), 0.0, False),
            A.embedding_dense_backward.default(g2, torch.tensor([1, 4]), 6,
                                               -1, False),
            A.slice_backward.default(g3, [3, 4], 1, 1, 3, 1),
            A.permute.default(x, [0, 2, 3, 1]), A.transpose.int(t, 0, 1),
            A.transpose_.default(t.clone(), 0, 1), A.unsqueeze.default(t, 1),
            A.squeeze.dim(t.unsqueeze(0), 0),
            A.squeeze.default(t.unsqueeze(1)), A.split.Tensor(t, 2, 1),
            A.stack.default([t, u], 1), A.concat.default([t, u], 0),
            A.narrow.default(t, 1, 1, 2), A.numpy_T.default(x),
            A.alias.default(t), A.clone.default(t),
            A.contiguous.default(t.t()), A._unsafe_view.default(t2, [4, 3]),
            A._to_copy.default(t, dtype=torch.float64),
            A.type_as.default(t, u), A.resolve_conj.default(t),
            A.resolve_neg.default(t), A.new_zeros.default(t, [2, 2]),
            A.new_empty.default(t, [2, 2]), A.zeros.default([2, 3]),
            A.full.default([2, 2], 1.5), A.empty_strided.default([2, 2],
                                                                 [2, 1]),
            A.empty_like.default(t), A.arange.default(5),
            A.arange.start_step(1, 7, 2), A.zero_.default(t.clone()),
            A.fill_.Scalar(t.clone(), 0.25),
            A.copy_.default(torch.empty(3, 4), u),
            A.index_put_.default(t.clone(), [idx], torch.ones(2, 4), True),
            A._index_put_impl_.default(t.clone(), [None, idx],
                                       torch.ones(3, 2), False, False),
            A.flatten_dense_tensors.default([t, m]),
            A.unflatten_dense_tensors.default(flat, [t, m]),
            A._foreach_add.Scalar([t, m], 1.0),
            A._foreach_add.List([t, m], [u, m], alpha=2),
            A._foreach_mul.Scalar([t, m], 2.0),
            A._foreach_div.Scalar([t, m], 2.0),
            A._foreach_lerp.Scalar([t, m], [u, m + 1], 0.5),
            A._foreach_addcmul.Scalar([t, m], [t, m], [u, m], 0.5),
            A._foreach_addcdiv.Scalar([t, m], [t, m], [u + 1, m + 1], 0.5),
            A.slice.Tensor(t, 1, 1, 2 ** 63 - 1, 2),
            A.linear.default(m, v.t()),
        ]
    return run


PROGRAMS = {"conv_bn_pool_ce_sgd": conv_step,
            "layernorm_gelu_embedding_softmax_adam": lm_adam_step,
            "dropout_nll_log_softmax": dropout_nll,
            "cat_split_chunk_slice_select_index_cumsum_where": indexing,
            "direct_aten_calls": direct_aten}


@pytest.fixture(scope="module")
def traces():
    return {name: record(make()) for name, make in PROGRAMS.items()}


# --------------------------------------------------------- hand-built nodes
def _desc(tid, shape, dtype="float"):
    n = int(np.prod(shape)) if shape else 1
    return ([tid, tid, 0, n, 4, "cuda:0"], list(shape), f"Tensor({dtype})")


def one_node(name, inputs, outputs, backend=""):
    """A trace of one node: ``inputs`` / ``outputs`` hold (desc, shape,
    type) triples for tensors and (value, type) pairs for literals."""
    def split(slots):
        vals, shapes, types = [], [], []
        for s in slots:
            if len(s) == 3:
                vals.append(s[0])
                shapes.append(s[1])
                types.append(s[2])
            else:
                vals.append(s[0])
                shapes.append([])
                types.append(s[1])
        return vals, shapes, types

    iv, ish, it = split(inputs)
    ov, osh, ot = split(outputs)
    node = {"id": 2, "name": name, "parent": 1,
            "op_schema": "" if backend else f"{name}(...) -> ...",
            "inputs": iv, "input_types": it, "input_shapes": ish,
            "outputs": ov, "output_types": ot, "output_shapes": osh}
    if backend:
        node["kernel_backend"] = backend
    root = {"id": 1, "name": "[root]", "parent": 1, "inputs": [],
            "input_types": [], "input_shapes": [], "outputs": [],
            "output_types": [], "output_shapes": []}
    return {"schema": "1.0.1", "nodes": [root, node]}


def _lookup_inputs(weights_at, indices_at, n_slots):
    slots = [(1, "Int")] * n_slots
    slots[weights_at] = _desc(10, [1000])
    slots[indices_at] = _desc(11, [24], "long int")
    return slots


HAND_BUILT = {
    "fbgemm::asynchronous_complete_cumsum": one_node(
        "fbgemm::asynchronous_complete_cumsum",
        [_desc(10, [5], "long int")], [_desc(20, [6], "long int")]),
    "fbgemm::bounds_check_indices": one_node(
        "fbgemm::bounds_check_indices",
        [_desc(10, [4], "long int"), _desc(11, [8], "long int")], []),
    "fbgemm::permute_2D_sparse_data": one_node(
        "fbgemm::permute_2D_sparse_data",
        [_desc(10, [3], "int"), _desc(11, [3, 4], "long int"),
         _desc(12, [12], "long int")],
        [_desc(20, [3, 4], "long int"), _desc(21, [12], "long int"),
         _desc(22, [12], "float")]),
    "fbgemm::dense_embedding_codegen_lookup_function": one_node(
        "fbgemm::dense_embedding_codegen_lookup_function",
        _lookup_inputs(0, 7, 9), [_desc(20, [4, 16])]),
    "fbgemm::split_embedding_codegen_lookup_sgd_function": one_node(
        "fbgemm::split_embedding_codegen_lookup_sgd_function",
        _lookup_inputs(1, 11, 13), [_desc(20, [4, 16])]),
    "fbgemm::split_embedding_codegen_lookup_adagrad_function": one_node(
        "fbgemm::split_embedding_codegen_lookup_adagrad_function",
        _lookup_inputs(1, 11, 13), [_desc(20, [6, 8])]),
    "fbgemm::split_embedding_codegen_lookup_rowwise_adagrad_function":
        one_node(
            "fbgemm::split_embedding_codegen_lookup_rowwise_adagrad_function",
            _lookup_inputs(1, 11, 13), [_desc(20, [3, 32])]),
    "aten::adaptive_avg_pool2d_backward": one_node(
        "aten::adaptive_avg_pool2d_backward",
        [_desc(10, [2, 3, 2, 2]), _desc(11, [2, 3, 4, 4])],
        [_desc(20, [2, 3, 4, 4])]),
    "aten::binary_cross_entropy_with_logits_backward": one_node(
        "aten::binary_cross_entropy_with_logits_backward",
        [_desc(10, []), _desc(11, [3, 4]), _desc(12, [3, 4]),
         (None, "None"), (None, "None"), (1, "Int")],
        [_desc(20, [3, 4])]),
    "aten::cudnn_batch_norm": one_node(
        "aten::cudnn_batch_norm",
        [_desc(10, [2, 3, 4, 4]), _desc(11, [3]), _desc(12, [3]),
         _desc(13, [3]), _desc(14, [3]), (True, "Bool"), (0.1, "Double"),
         (1e-5, "Double")],
        [_desc(20, [2, 3, 4, 4]), _desc(21, [3]), _desc(22, [3]),
         _desc(23, [0], "unsigned char")]),
    "aten::cudnn_batch_norm_backward": one_node(
        "aten::cudnn_batch_norm_backward",
        [_desc(10, [2, 3, 4, 4]), _desc(11, [2, 3, 4, 4]), _desc(12, [3]),
         _desc(13, [3]), _desc(14, [3]), _desc(15, [3]), _desc(16, [3]),
         (1e-5, "Double"), _desc(17, [0], "unsigned char")],
        [_desc(20, [2, 3, 4, 4]), _desc(21, [3]), _desc(22, [3])]),
    "aten::record_stream": one_node(
        "aten::record_stream", [_desc(10, [4]), ("<stream>", "Stream")], []),
    "aten::pin_memory": one_node(
        "aten::pin_memory", [_desc(10, [4]), (None, "None")],
        [_desc(20, [4])]),
    "triton_poi_fused_add_0": one_node(
        "triton_poi_fused_add_0", [_desc(10, [4, 4]), _desc(11, [4])],
        [_desc(20, [4, 4])], backend="triton"),
}


# ------------------------------------------------------------------ tests
def test_op_tables_have_the_same_names():
    assert supported_aten_ops() == ref.supported_aten_ops()
    assert len(supported_aten_ops()) == 153


@pytest.mark.parametrize("cast", [None, "bf16"])
@pytest.mark.parametrize("tok", ["Tensor(float)", "Tensor(double)",
                                 "Tensor(c10::Half)", "Tensor(c10::BFloat16)",
                                 "Tensor(long int)", "Tensor(int)",
                                 "Tensor(bool)", "Tensor(unsigned char)",
                                 "Tensor(c10::complex<float>)"])
def test_materialization_is_bitwise_the_reference(tok, cast):
    data = one_node("aten::relu", [], [])
    jr = ref.PyTorchOpReplay(data, cast=cast)
    pr = PyTorchOpReplay(data, cast=cast, device="cpu")
    for shape in ([3, 5], [], [0, 4], [2, 1, 7]):
        desc = [1234, 99, 0, 1, 4, "cpu"]
        jr._cur_shape = pr._cur_shape = list(shape)
        jv, pv = jr._materialize(desc, tok), pr._materialize((1234, 99), tok)
        assert _jax_dtype(pv) == jnp.asarray(jv).dtype
        assert tuple(pv.shape) == tuple(shape)
        assert np.array_equal(_np(jv), _np(pv))


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_recorded_program_matches_the_reference(program, traces):
    _, pr, jrep, prep = lockstep(traces[program])
    assert prep["num_executed"] > 10
    # what no mapping exists for is skipped by both (e.g. aten::rand)
    assert all("mapping" in why for why in prep["skipped"].values())


@pytest.mark.parametrize("name", sorted(HAND_BUILT))
def test_hand_built_node_matches_the_reference(name):
    _, pr, _, prep = lockstep(HAND_BUILT[name])
    assert prep["skipped"] == {} and prep["num_executed"] == 1
    label = f"triton:{name}" if name.startswith("triton") else name
    assert prep["per_op"][label]["count"] == 1


def test_fbgemm_blob_shrinks_as_the_reference():
    data = HAND_BUILT["fbgemm::split_embedding_codegen_lookup_sgd_function"]
    _, pr, _, prep = lockstep(data, max_tensor_bytes=1000)
    assert prep["shrunk_tensors"] == {
        "(10, 10)": {"recorded": [1000], "surrogate": [250]}}


def test_every_supported_op_is_exercised(traces):
    seen = set(HAND_BUILT)
    for data in traces.values():
        seen |= {n.name for n in PyTorchOpReplay(data, device="cpu").nodes}
    assert set(supported_aten_ops()) <= seen, \
        sorted(set(supported_aten_ops()) - seen)


def _train_et():
    with gzip.open(os.path.join(FIXTURES, "transformer_train_et.json.gz"),
                   "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("cast", [None, "bf16"])
@pytest.mark.parametrize("fuse", [None, "attention", "attention-train"])
def test_transformer_train_fixture_matches_the_reference(fuse, cast):
    jr, pr, jrep, prep = lockstep(_train_et(), cast=cast, fuse=fuse)
    assert prep["skipped"] == {} and prep["num_selected"] == 226
    fwd = prep["per_op"].get("fused::flash_attention", {}).get("count", 0)
    bwd = prep["per_op"].get("fused::flash_attention_bwd", {}).get("count",
                                                                   0)
    assert (fwd, bwd) == {None: (0, 0), "attention": (2, 0),
                          "attention-train": (2, 2)}[fuse]
    assert prep["num_executed"] == {None: 226, "attention": 214,
                                    "attention-train": 190}[fuse]
    # a replayed backward window's gradients are exactly zero in both:
    # the synthesized lse's 1e6 offset underflows P
    for w in pr.fused_bwd_windows:
        for _, desc, _, _ in w.outs:
            k = tensor_key(desc)
            assert not _np(jr.registry[k]).any()
        base = 1_000_000_000 + 2 * w.index
        assert pr.registry[(base + 1, base + 1)].shape == w.shape[:3]


def test_chain_on_cpu_matches_the_reference(traces):
    """chain(n): the 1e-30-weighted carry of n iterations, against the JAX
    package's chained program on the same trace (rtol 1e-4: a sum over
    every float output, added in another order)."""
    data = traces["conv_bn_pool_ce_sgd"]
    jchain = ref.PyTorchOpReplay(data).build_chain()
    pr = PyTorchOpReplay(data, device="cpu")
    chain = pr.build_chain()
    for n in (1, 2):
        want, got = float(jchain(n)), chain(n)
        assert got.shape == () and got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-4)
    assert pr.registry == {}  # externals live in the chain, not the registry


def test_chain_on_cpu_runs_the_fused_windows(monkeypatch):
    calls = []
    real = port.PyTorchOpReplay._fused_attention_outs

    def spy(self, w):
        calls.append(type(w).__name__)
        return real(self, w)

    monkeypatch.setattr(port.PyTorchOpReplay, "_fused_attention_outs", spy)
    r = PyTorchOpReplay(_train_et(), fuse="attention-train", device="cpu")
    chain = r.build_chain()
    assert np.isfinite(float(chain(2)))
    # the eager pass, then two iterations: 2 forward + 2 backward each
    assert calls.count("AttnWindow") == 6
    assert calls.count("AttnBwdWindow") == 6
    assert r.measure_chain_iteration(n=1, reps=1, chain=chain) > 0


def test_codegen_runs_standalone(tmp_path):
    """The generated script runs on ``--device cpu`` in a subprocess,
    prints ``replayed N ops OK`` and loads neither JAX nor the reference
    package; run in this process its registry equals the replay's, bit
    for bit (the same impls on the same inputs in the same order)."""
    data = _train_et()
    r = PyTorchOpReplay(data, device="cpu")
    src = r.codegen("transformer_train_et")
    assert "import jax" not in src and "param_tpu." not in src
    script = tmp_path / "replay_train.py"
    script.write_text(src)
    code = ("import runpy, sys\n"
            f"sys.argv = [{str(script)!r}, '--device', 'cpu']\n"
            f"runpy.run_path({str(script)!r}, run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'param_tpu')]\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "replayed 226 ops OK" in p.stdout
    mod = {}
    exec(compile(src, str(script), "exec"), mod)
    mod["DEV"] = torch.device("cpu")
    mod["run_stream"]()
    r.replay(iters=1, timed=False)
    assert set(mod["R"]) == set(r.registry)
    for k, v in r.registry.items():
        assert torch.equal(mod["R"][k], v), k


def test_codegen_comments_skipped_ops():
    data = one_node("aten::nonexistent_op", [_desc(10, [2, 2])],
                    [_desc(20, [2, 2])])
    src = PyTorchOpReplay(data, device="cpu").codegen()
    assert "# skipped: aten::nonexistent_op (no PyTorch mapping)" in src
    assert "replayed 0 ops OK" in src


def _allreduce_trace():
    """A trace recorded on a gloo world of one around ``linear ->
    all_reduce -> relu``.  torch's gloo backend records no
    ``record_param_comms`` node (NCCL does), so the one NCCL would write
    (the port's exporter's layout) takes the place of the gloo record
    beside the ``c10d::allreduce_`` node."""
    import torch.distributed as dist

    from param_tpu_torch.trace.export_pytorch_et import export_pytorch_et
    from param_tpu_torch.trace.comms_trace import CommsOp

    assert dist.is_initialized() and dist.get_world_size() == 1
    torch.manual_seed(0)
    lin, x = torch.nn.Linear(16, 16), torch.rand(16)

    def run():
        y = lin(x)
        dist.all_reduce(y)
        return torch.relu(y)

    data = record(run)
    gloo = next(n for n in data["nodes"] if n["name"] == "gloo:all_reduce")
    rpc = export_pytorch_et([CommsOp(comms="all_reduce", in_msg_size=16,
                                     out_msg_size=16, dtype="float32")],
                            1)["nodes"][-1]
    rpc.update(id=gloo["id"], ctrl_deps=gloo["ctrl_deps"])
    data["nodes"] = [rpc if n is gloo else n for n in data["nodes"]]
    return data


@pytest.fixture
def gloo_world():
    from param_tpu_torch.backend import DistBackend

    b = DistBackend("cpu")  # a world of one on gloo
    b.initialize()
    try:
        yield b
    finally:
        b.shutdown()


def test_full_mode_on_a_gloo_world_of_one(gloo_world):
    """``mode="full"`` runs the recorded all_reduce through the backend at
    its position; the compute ops match the JAX package's comp-mode replay
    of the same trace."""
    data = _allreduce_trace()
    pr = PyTorchOpReplay(data, mode="full", backend=gloo_world, device="cpu")
    names = [n.name for n in pr.nodes]
    assert names == ["aten::linear", "record_param_comms", "aten::relu"]
    rep = pr.replay(iters=2)
    assert rep["skipped"] == {} and rep["num_executed"] == 6
    assert rep["per_op"]["comm:all_reduce"]["count"] == 2
    lockstep(data)  # comp mode against the JAX package's
    comp = PyTorchOpReplay(data, device="cpu")
    assert [n.name for n in comp.nodes] == ["aten::linear", "aten::relu"]
    comp.replay(iters=2)
    for k, v in comp.registry.items():
        assert torch.equal(pr.registry[k], v), k


def _mini_trace(op_name="aten::nonexistent_op"):
    """tests/test_pytorch_op_replay.py's skip-path trace."""
    return {"schema": "1.0.1", "nodes": [
        {"id": 1, "name": "[root]", "parent": 1, "inputs": [],
         "input_types": [], "input_shapes": [], "outputs": [],
         "output_types": [], "output_shapes": []},
        {"id": 2, "name": op_name, "parent": 1,
         "op_schema": f"{op_name}(Tensor self) -> Tensor",
         "inputs": [[10, 11, 0, 4, 4, "cuda:0"]],
         "input_types": ["Tensor(float)"], "input_shapes": [[2, 2]],
         "outputs": [[12, 13, 0, 4, 4, "cuda:0"]],
         "output_types": ["Tensor(float)"], "output_shapes": [[2, 2]]},
        {"id": 3, "name": "aten::relu", "parent": 1,
         "op_schema": "aten::relu(Tensor self) -> Tensor",
         "inputs": [[10, 11, 0, 4, 4, "cuda:0"]],
         "input_types": ["Tensor(float)"], "input_shapes": [[2, 2]],
         "outputs": [[14, 15, 0, 4, 4, "cuda:0"]],
         "output_types": ["Tensor(float)"], "output_shapes": [[2, 2]]},
    ]}


def test_unknown_op_skips_and_updates_the_config(tmp_path):
    cfg = tmp_path / "skip.json"
    r = PyTorchOpReplay(_mini_trace(), skip_config_path=str(cfg),
                        device="cpu")
    rep = r.replay(iters=1)
    assert rep["num_executed"] == 1  # the relu still ran
    assert "aten::nonexistent_op" in rep["skipped"]
    saved = json.loads(cfg.read_text())
    assert "aten::nonexistent_op" in saved["skip nodes"]
    assert set(saved["skip nodes"]) == set(ref.PyTorchOpReplay(
        _mini_trace()).replay(iters=1)["skipped"])


def test_preloaded_skip_names_are_respected():
    r = PyTorchOpReplay(_mini_trace("aten::neg"), skip_names={"aten::neg"},
                        device="cpu")
    rep = r.replay(iters=1)
    assert rep["num_executed"] == 1  # only the relu
    assert "aten::neg" not in rep["per_op"] and rep["skipped"] == {}


def test_unsupported_variant_skips():
    data = one_node("aten::convolution",
                    [_desc(10, [1, 2, 4, 4]), _desc(11, [2, 2, 3, 3]),
                     (None, "None"), ([1, 1], "GenericList[Int,Int]"),
                     ([0, 0], "GenericList[Int,Int]"),
                     ([1, 1], "GenericList[Int,Int]"), (True, "Bool"),
                     ([0, 0], "GenericList[Int,Int]"), (1, "Int")],
                    [_desc(20, [1, 2, 6, 6])])
    _, _, _, prep = lockstep(data)
    assert prep["skipped"] == {"aten::convolution": "transposed convolution"}


def test_a_failing_op_raises_and_is_not_skipped():
    """An error that is neither a missing mapping nor an UnsupportedOp
    raises (the JAX package turns it into a skip), with the node named."""
    data = one_node("aten::mm", [_desc(10, [2, 3]), _desc(11, [4, 5])],
                    [_desc(20, [2, 5])])
    with pytest.raises(RuntimeError) as err:
        PyTorchOpReplay(data, device="cpu").replay(iters=1)
    assert "aten::mm (node 2)" in "".join(getattr(err.value, "__notes__",
                                                  []))
    assert "aten::mm" in ref.PyTorchOpReplay(data).replay(iters=1)["skipped"]


def test_a_failing_fused_window_raises(monkeypatch):
    """A fused window whose kernel call fails raises: it never becomes a
    skipped window (the JAX package logs a warning and skips it)."""
    import param_tpu_torch.ops.attention as attention

    def broken(*a, **k):
        raise RuntimeError("K6 launch failed")

    monkeypatch.setattr(attention, "flash_attention", broken)
    r = PyTorchOpReplay(_train_et(), fuse="attention", device="cpu")
    with pytest.raises(RuntimeError, match="K6 launch failed"):
        r.replay(iters=1, timed=False)
    assert r.skipped == {}


def test_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PyTorchOpReplay(_mini_trace())


# The JAX package's torch-matching checks of its trickier impls
# (tests/test_pytorch_op_replay.py:384-507), each also held to the JAX impl.
def _both(name, args, meta=None):
    meta = dict(meta or {}, name=name, schema="")
    jargs = [np.asarray(a) if isinstance(a, torch.Tensor) else a
             for a in args]
    return (_ATEN[name](args, meta),
            ref._ATEN[name](jargs, {"name": name, "schema": ""}))


def _close(got, want, jax_out, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(got), _np(jax_out), rtol=rtol, atol=atol)


def test_threshold_backward_matches_torch():
    x = torch.randn(8, 16, requires_grad=True)
    g = torch.randn(8, 16)
    torch.relu(x).backward(g)
    got, jax_out = _both("aten::threshold_backward", [g, x.detach(), 0.0])
    _close(got[0], x.grad, jax_out[0], 1e-6, 0)


def test_batch_norm_backward_matches_torch():
    torch.manual_seed(0)
    x = torch.randn(4, 3, 5, 5, requires_grad=True)
    w = torch.randn(3, requires_grad=True)
    b = torch.randn(3, requires_grad=True)
    out = F.batch_norm(x, None, None, w, b, training=True, eps=1e-5)
    g = torch.randn_like(out)
    out.backward(g)
    got, jax_out = _both("aten::cudnn_batch_norm_backward",
                         [x.detach(), g, w.detach(), None, None, None, None,
                          1e-5, None])
    for i, want in enumerate((x.grad, w.grad, b.grad)):
        _close(got[i], want, jax_out[i], 1e-4, 1e-5)


def test_convolution_backward_matches_torch():
    torch.manual_seed(0)
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    out = F.conv2d(x, w, stride=2, padding=1)
    g = torch.randn_like(out)
    out.backward(g)
    got, jax_out = _both("aten::convolution_backward",
                         [g, x.detach(), w.detach(), [4], [2, 2], [1, 1],
                          [1, 1], False, [0, 0], 1, [True, True, True]])
    _close(got[0], x.grad, jax_out[0], 1e-4, 1e-5)
    _close(got[1], w.grad, jax_out[1], 1e-4, 1e-5)
    _close(got[2], g.sum((0, 2, 3)), jax_out[2], 1e-4, 1e-5)


def test_nll_loss_backward_matches_torch():
    torch.manual_seed(0)
    logits = torch.randn(6, 10)
    target = torch.randint(0, 10, (6,))
    logp = torch.log_softmax(logits, dim=-1).requires_grad_()
    F.nll_loss(logp, target).backward()
    got, jax_out = _both("aten::nll_loss_backward",
                         [torch.tensor(1.0), logp.detach(), target, None, 1,
                          -100, None])
    _close(got[0], logp.grad, jax_out[0], 1e-5, 1e-6)


def test_max_pool_backward_matches_torch():
    torch.manual_seed(0)
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    out = F.max_pool2d(x, 3, stride=2, padding=1)
    g = torch.randn_like(out)
    out.backward(g)
    got, jax_out = _both("aten::max_pool2d_with_indices_backward",
                         [g, x.detach(), [3, 3], [2, 2], [1, 1], [1, 1],
                          False, None])
    _close(got[0], x.grad, jax_out[0], 1e-5, 1e-6)


def test_layer_norm_backward_matches_torch():
    torch.manual_seed(0)
    x = torch.randn(4, 6, 16, requires_grad=True)
    w = torch.randn(16, requires_grad=True)
    out = F.layer_norm(x, [16], weight=w)
    g = torch.randn_like(out)
    out.backward(g)
    got, jax_out = _both("aten::native_layer_norm_backward",
                         [g, x.detach(), [16], None, None, w.detach(), None,
                          [True, True, True]])
    _close(got[0], x.grad, jax_out[0], 1e-4, 1e-5)
    _close(got[1], w.grad, jax_out[1], 1e-4, 1e-5)


def test_as_strided_contiguous_view():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    got, jax_out = _both("aten::as_strided", [x, [2, 4], [4, 1], 4])
    assert torch.equal(got[0], x.reshape(-1)[4:].reshape(2, 4))
    assert np.array_equal(_np(got[0]), _np(jax_out[0]))


def test_window_dataclasses_are_the_references():
    """The fused windows the replay reports are the JAX package's."""
    data = _train_et()
    r = PyTorchOpReplay(data, fuse="attention-train", device="cpu")
    jr = ref.PyTorchOpReplay(data, fuse="attention-train")
    assert [dataclasses.asdict(w) for w in r.fused_bwd_windows] == \
        [dataclasses.asdict(w) for w in jr.fused_bwd_windows]
    assert r.report(0, 0.0, 1)["fused_attention_windows"] == \
        jr.report(0, 0.0, 1)["fused_attention_windows"]


def test_timed_replay_registers_what_the_untimed_one_does():
    """Discrete mode's timed call (after the untimed one, whose outputs it
    frees first, a backward window's gradients included) leaves the same
    registry, bit for bit."""
    data = _train_et()
    plain = PyTorchOpReplay(data, fuse="attention-train", device="cpu")
    timed = PyTorchOpReplay(data, fuse="attention-train", device="cpu")
    plain.replay(iters=1, timed=False)
    rep = timed.replay(iters=1, timed=True)
    assert set(timed.registry) == set(plain.registry)
    for k, v in plain.registry.items():
        assert torch.equal(timed.registry[k], v), k
    assert all(len(timed.stats[name].lat_us) == s["count"]
               for name, s in rep["per_op"].items())
