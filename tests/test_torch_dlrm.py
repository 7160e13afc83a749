"""The port's single-device DLRM against the reference on a one-device mesh:
interaction pair order, forward, loss, and parameters and accumulators
after two steps of each optimizer.

Both start from the reference's parameters (``params_from_jax``) and the
same numpy batches.  The sparse reference steps run the Pallas row-update
kernel in interpret mode (``table_update="pallas"``).  Tolerance: f32
rtol=1e-5, atol=1e-6 (atol=1e-5 where logits or interaction dots of
magnitude ~1 are compared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from param_tpu.models import dlrm as jdlrm
from param_tpu.models.dlrm_data import RandomDataset
from param_tpu_torch.backend.base import CommGroup
from param_tpu_torch.models.convert import adagrad_state_from_jax, params_from_jax
from param_tpu_torch.models.dlrm import (
    DlrmConfig, DlrmModel, dot_interaction, init_dlrm_params,
)
from param_tpu_torch.ops.mlp import make_optimizer

TINY = dict(num_tables=4, rows_per_table=512, emb_dim=16, nnz=4, dense_dim=16,
            bot_mlp=[32, 16], top_mlp=[32, 1], batch=64)
LR = 0.05


def _flat(tree):
    """Leaves of a params tree (reference or port) as numpy, in order."""
    out = [tree["tables"]]
    for key in ("bot", "top"):
        for w, b in tree[key]:
            out += [w, b]
    return [np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)
            for t in out]


def _assert_trees_close(got, want, rtol, atol):
    for g, w in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _batches(cfg, n):
    return list(RandomDataset(batch=cfg["batch"], dense_dim=cfg["dense_dim"],
                              num_tables=cfg["num_tables"], nnz=cfg["nnz"],
                              num_rows=cfg["rows_per_table"], num_batches=n))


def test_tril_pair_order_matches_jax():
    for m in (2, 3, 9, 27):
        li, lj = jnp.tril_indices(m, k=-1)
        t = torch.tril_indices(m, m, offset=-1)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(li))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(lj))


def test_dot_interaction_matches_jax():
    rng = np.random.default_rng(0)
    bot = rng.standard_normal((8, 16)).astype(np.float32)
    pooled = rng.standard_normal((8, 5, 16)).astype(np.float32)
    want = np.asarray(jdlrm.dot_interaction(jnp.asarray(bot),
                                            jnp.asarray(pooled)))
    got = dot_interaction(torch.from_numpy(bot), torch.from_numpy(pooled))
    assert got.shape == (8, 16 + 6 * 5 // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_config_matches_reference():
    for kw in (TINY, {}, dict(TINY, arch_interaction="cat")):
        a, b = jdlrm.DlrmConfig(**kw), DlrmConfig(**kw)
        assert a.interaction_dim == b.interaction_dim
        assert a.top_mlp_dims() == b.top_mlp_dims()
    with pytest.raises(ValueError):
        DlrmConfig(bot_mlp=[32, 99])


def test_forward_and_loss_on_entry_config():
    """The reference's compile target (``__graft_entry__.entry``)."""
    from __graft_entry__ import entry

    fn, (jparams, dense, idx) = entry()
    want = np.asarray(jax.jit(fn)(jparams, dense, idx))
    kw = dict(num_tables=8, rows_per_table=10_000, emb_dim=32, nnz=8,
              dense_dim=32, bot_mlp=[64, 32], top_mlp=[64, 1], batch=256)
    model = DlrmModel(DlrmConfig(**kw), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    labels = (np.random.default_rng(0).random(256) < 0.5).astype(np.float32)
    d, i, l = model.place_batch((np.asarray(dense), np.asarray(idx), labels))
    with torch.no_grad():
        got = model.forward(params, d, i)
        loss = model.loss_fn(params, d, i, l)
    assert got.shape == (256,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    jmodel = jdlrm.DlrmModel(jdlrm.DlrmConfig(**kw))
    want_loss = float(jmodel.loss_fn(jparams, dense, idx, jnp.asarray(labels)))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)


def _run_jax(opt_name, jparams, batches):
    cfg = jdlrm.DlrmConfig(**TINY)
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    model = jdlrm.DlrmModel(cfg, mesh)
    p, _ = model.place(jparams, batches[0])
    losses, st = [], None
    if opt_name in ("sgd", "adagrad"):
        opt = optax.sgd(LR) if opt_name == "sgd" else optax.adagrad(LR)
        step = model.make_train_step(opt)
        st = opt.init(p)
        for b in batches:
            p, st, loss = step(p, st, *model.place_batch(b))
            losses.append(float(loss))
        acc = None if opt_name == "sgd" else st[0].sum_of_squares
    elif opt_name == "sparse_sgd":
        step = model.make_sparse_sgd_step(LR, table_update="pallas")
        for b in batches:
            p, loss = step(p, *model.place_batch(b))
            losses.append(float(loss))
        acc = None
    else:
        step = model.make_sparse_adagrad_step(LR, table_update="pallas")
        acc = model.init_adagrad_state(p)
        for b in batches:
            p, acc, loss = step(p, acc, *model.place_batch(b))
            losses.append(float(loss))
    tree = jax.tree.map(np.asarray, p)
    acc = jax.tree.map(np.asarray, acc) if acc is not None else None
    return tree, acc, losses


def _run_port(opt_name, np_params, batches):
    model = DlrmModel(DlrmConfig(**TINY), device="cpu")
    p = params_from_jax(np_params, "cpu")
    losses, acc = [], None
    if opt_name in ("sgd", "adagrad"):
        opt = make_optimizer(opt_name, LR)
        step = model.make_train_step(opt)
        acc = opt.init(p)
        for b in batches:
            p, acc, loss = step(p, acc, *model.place_batch(b))
            losses.append(float(loss))
    elif opt_name == "sparse_sgd":
        step = model.make_sparse_sgd_step(LR)
        for b in batches:
            p, loss = step(p, *model.place_batch(b))
            losses.append(float(loss))
    else:
        step = model.make_sparse_adagrad_step(LR)
        acc = model.init_adagrad_state(p)
        for b in batches:
            p, acc, loss = step(p, acc, *model.place_batch(b))
            losses.append(float(loss))
    return p, acc, losses


@pytest.mark.parametrize("opt_name",
                         ["sgd", "adagrad", "sparse_sgd", "sparse_adagrad"])
def test_two_steps_match_jax(opt_name):
    jparams = jdlrm.init_dlrm_params(jax.random.PRNGKey(0),
                                     jdlrm.DlrmConfig(**TINY))
    np_params = jax.tree.map(np.asarray, jparams)
    batches = _batches(TINY, 2)
    want_p, want_acc, want_losses = _run_jax(opt_name, jparams, batches)
    got_p, got_acc, got_losses = _run_port(opt_name, np_params, batches)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    _assert_trees_close(got_p, want_p, rtol=1e-5, atol=1e-6)
    if want_acc is not None:
        _assert_trees_close(got_acc, want_acc, rtol=1e-5, atol=1e-6)
    # the tables moved: the step really trained them
    assert not np.allclose(_flat(got_p)[0], np_params["tables"])


def test_sparse_adagrad_from_converted_state():
    """adagrad_state_from_jax carries an accumulator over (here with
    initial value 0: the gated factor leaves untouched rows exactly)."""
    cfg = jdlrm.DlrmConfig(**TINY)
    jparams = jdlrm.init_dlrm_params(jax.random.PRNGKey(1), cfg)
    np_params = jax.tree.map(np.asarray, jparams)
    np_acc = jax.tree.map(np.zeros_like, np_params)
    model = DlrmModel(DlrmConfig(**TINY), device="cpu")
    p = params_from_jax(np_params, "cpu")
    acc = adagrad_state_from_jax(np_acc, "cpu")
    dense, idx, labels = _batches(TINY, 1)[0]
    step = model.make_sparse_adagrad_step(LR, initial_accumulator=0.0)
    p, acc, loss = step(p, acc, *model.place_batch((dense, idx, labels)))
    assert np.isfinite(float(loss))
    touched = np.zeros((4, 512), bool)
    for t in range(4):
        touched[t, np.unique(idx[:, t])] = True
    tab = p["tables"].detach().numpy()
    np.testing.assert_array_equal(tab[~touched], np_params["tables"][~touched])
    assert (acc["tables"].numpy()[~touched] == 0).all()
    assert (acc["tables"].numpy()[touched].sum(-1) > 0).all()


def test_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    cfg = DlrmConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DlrmModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_dlrm_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"tables": np.zeros((1, 2, 2), np.float32),
                         "bot": [], "top": []})


def test_world_size_above_one_not_ported():
    """A world above one is ported (tests/test_torch_dlrm_sharded.py); what
    stays refused, with the reference's message, is a group whose size
    does not divide the tables or the batch."""
    for kw, ranks in ((TINY, 3), (dict(TINY, batch=63), 2)):
        group = CommGroup(ranks=list(range(ranks)))
        with pytest.raises(ValueError, match=r"must divide the mesh size"):
            DlrmModel(DlrmConfig(**kw), group=group, device="cpu")
        with pytest.raises(ValueError, match=r"must divide the mesh size"):
            jdlrm.DlrmModel(jdlrm.DlrmConfig(**kw),
                            Mesh(np.array(jax.devices()[:ranks]), ("x",)))


def test_init_params_shapes():
    model = DlrmModel(DlrmConfig(**TINY), device="cpu")
    p = model.init_params(3)
    assert p["tables"].shape == (4, 512, 16)
    assert [w.shape for w, _ in p["bot"]] == [(16, 32), (32, 16)]
    assert [w.shape for w, _ in p["top"]] == [(26, 32), (32, 1)]
    std = float(p["tables"].detach().std())
    assert abs(std - 512 ** -0.5) < 0.01
    torch.testing.assert_close(model.init_params(3)["tables"], p["tables"])
