"""The port's multi-device transformer tier against the reference's
``shard_map`` programs: ranks of spawned gloo worlds of 2 and 4
(tests/torch_parallel_worker.py, no JAX in the children) against
``param_tpu`` on a CPU mesh of the same size, both fed the same numbers
(the reference's initial parameters and numpy activations from a seed,
carried over by ``param_tpu_torch.models.convert``).

Compared, with the tolerances of the reference's own tests:
- ``ring_attention`` (causal and not, d 64 and 128, local S 128 and 256)
  against ``param_tpu.ops.ring_attention`` and ``mha_reference``: atol =
  rtol = 3e-5;
- head-parallel flash ((1, 2n, 256, 128) causal) against dry-run path 8's
  program: 2e-5;
- ``moe_apply_ep`` at capacity factors 1.25 and 8 against the reference's
  ``moe_apply_ep`` and ``moe_apply_reference`` (2e-5); the capacity drop at
  0.2 (some rows zero) and none at 16; one ``make_moe_train_step`` step
  (loss rel 1e-5, every parameter atol 1e-5);
- ``make_sharded_train_step`` at (dp, tp) = (1, 2), (2, 2), (1, 4) and (2,
  2) with GQA: loss rel 1e-5, parameters atol = rtol = 1e-5;
- ``make_pipeline_train_step`` with 2 stages (M 2 and 4) and 4 (M 4)
  against the reference's step and the sequential oracle: loss rel 1e-5,
  parameters atol 1e-6, rtol 1e-5;
- the dp x tp MLP step against dry-run path 5's program: loss and
  parameters rel 1e-5 (atol 1e-8 for the biases near zero);
- a ring hop and its backward, the reverse hop.
In one process: ``merge`` against the reference's ``_merge``, the ring's
schedule over in-process shards, ``tp_shard`` / ``tp_gather``, the
refusals, and each ``experiments.parallel_tier`` check in a world of one.
"""

import os
import pickle
import subprocess
import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from param_tpu.models import moe as jmoe
from param_tpu.models import transformer as jtfm
from param_tpu.ops import mlp as jmlp
from param_tpu.ops.attention import flash_attention as jflash
from param_tpu.ops.attention import mha_reference as jmha
from param_tpu.ops.ring_attention import _merge as jmerge
from param_tpu.ops.ring_attention import ring_attention as jring
from param_tpu_torch.backend import DistBackend
from param_tpu_torch.experiments import parallel_tier
from param_tpu_torch.models import convert, moe, transformer as tfm
from param_tpu_torch.ops.mlp import mlp_tp_shard
from param_tpu_torch.ops.ring_attention import merge, ring_attention_steps

import torch_parallel_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 120
WORLDS = (2, 4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _jcfg(**kw):
    return jtfm.TransformerConfig(batch=4, attention="xla", **{
        **worker.TFM, **kw})


# ------------------------------------------------------------ the inputs
@lru_cache(maxsize=None)
def _inputs():
    """Every world's inputs: numpy activations from a seed, the
    reference's initial parameters."""
    out = {}
    for n in WORLDS:
        rng = _rng(n)
        d = {}
        for case in worker.RING_CASES:
            _, hd, s = case
            d["ring", case] = tuple(
                (rng.standard_normal((1, 2, n * s, hd)) * 0.3).astype(
                    np.float32) for _ in range(3))
        d["heads"] = tuple(rng.standard_normal((1, 2 * n, 256, 128)).astype(
            np.float32) for _ in range(3))
        mcfg = jmoe.MoeConfig(worker.MOE["emb"], worker.MOE["ffn"], n)
        d["moe_params"] = _np(jmoe.init_moe_params(jax.random.PRNGKey(11),
                                                   mcfg))
        d["moe_x"] = (rng.standard_normal(
            (n * worker.MOE["tokens"], worker.MOE["emb"])) * 0.5).astype(
                np.float32)
        for kv in {kv for _, _, kv in worker.TP_CASES[n]}:
            cfg = _jcfg(kv_heads=kv)
            d["tp", kv] = dict(
                params=_np(jtfm.init_params(jax.random.PRNGKey(3), cfg)),
                x=(rng.standard_normal((4, cfg.seq, cfg.emb)) * 0.1).astype(
                    np.float32))
        for m in worker.PP_MICROBATCHES[n]:
            cfg = jtfm.TransformerConfig(batch=2 * m, attention="xla",
                                         **worker.PP_TFM)
            d["pp", m] = dict(
                params=_np(jtfm.init_stacked_params(jax.random.PRNGKey(5),
                                                    cfg, n)),
                x=(rng.standard_normal((cfg.batch, cfg.seq, cfg.emb))
                   * 0.1).astype(np.float32))
        d["mlp"] = dict(
            params=_np(jmlp.init_mlp(jax.random.PRNGKey(1), [16, 64, 64, 1])),
            x=rng.standard_normal((32, 16)).astype(np.float32),
            y=rng.standard_normal(32).astype(np.float32))
        out[n] = d
    return out


def _mesh(n, names=("x",)):
    return Mesh(np.array(jax.devices()[:n]), names)


# --------------------------------------------------------- spawned worlds
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results, both worlds run at once."""
    base = tmp_path_factory.mktemp("parallel_worlds")
    in_file = str(base / "inputs.pkl")
    with open(in_file, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs, dirs = {}, {}
    for n in WORLDS:
        dirs[n] = str(base / f"world{n}")
        os.makedirs(dirs[n])
        procs[n] = [subprocess.Popen(
            [sys.executable,
             os.path.join(ROOT, "tests", "torch_parallel_worker.py"),
             os.path.join(dirs[n], "store"), str(r), str(n), in_file, dirs[n]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n)]
    for n in WORLDS:
        logs = []
        try:
            for p in procs[n]:
                logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for p in procs[n]:
                p.kill()
                p.communicate()
            pytest.fail(f"gloo world of {n} did not finish in "
                        f"{WORLD_TIMEOUT_S} s")
        bad = [(r, p.returncode, log) for r, (p, log) in
               enumerate(zip(procs[n], logs)) if p.returncode != 0]
        assert not bad, f"gloo world of {n}: ranks failed: {bad}"
    return {n: [torch.load(os.path.join(dirs[n], f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
            for n in WORLDS}


# ------------------------------------------------------------------ ring
@lru_cache(maxsize=None)
def _jax_ring(n, case):
    causal, _, s = case
    q, k, v = _inputs()[n]["ring", case]
    spec = P(None, None, "sp", None)
    fn = jax.jit(jax.shard_map(
        lambda q, k, v: jring(q, k, v, "sp", causal=causal, block_q=s,
                              block_k=s),
        mesh=_mesh(n, ("sp",)), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False))
    return np.asarray(fn(q, k, v)), np.asarray(jmha(q, k, v, causal=causal))


@pytest.mark.parametrize("case", worker.RING_CASES,
                         ids=lambda c: f"causal{int(c[0])}-d{c[1]}-s{c[2]}")
@pytest.mark.parametrize("n", WORLDS)
def test_ring_attention_matches_jax(worlds, n, case):
    got = np.concatenate([r["ring", case] for r in worlds[n]], axis=2)
    ring, oracle = _jax_ring(n, case)
    np.testing.assert_allclose(got, ring, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_head_parallel_flash_matches_path_8(worlds, n):
    q, k, v = _inputs()[n]["heads"]
    fn = jax.jit(jax.shard_map(
        lambda q, k, v: jflash(q, k, v, causal=True, block_q=128,
                               block_k=128),
        mesh=_mesh(n, ("tp",)), in_specs=(P(None, "tp"),) * 3,
        out_specs=P(None, "tp"), check_vma=False))
    got = np.concatenate([r["heads"] for r in worlds[n]], axis=1)
    np.testing.assert_allclose(got, np.asarray(fn(q, k, v)), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jmha(q, k, v, causal=True)),
                               atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------------- MoE
def _moe_cfg(n, cf=1.25):
    return jmoe.MoeConfig(worker.MOE["emb"], worker.MOE["ffn"], n,
                          capacity_factor=cf)


@lru_cache(maxsize=None)
def _jax_moe(n, cf):
    data = _inputs()[n]
    cfg = _moe_cfg(n, cf)
    ep = jax.jit(jax.shard_map(
        lambda p, x: jmoe.moe_apply_ep(p, x, "ep", cfg),
        mesh=_mesh(n, ("ep",)), in_specs=(jmoe.moe_param_specs(), P("ep")),
        out_specs=P("ep"), check_vma=False))(data["moe_params"],
                                             data["moe_x"])
    ref = jmoe.moe_apply_reference(data["moe_params"], data["moe_x"], cfg,
                                   n_senders=n)
    return np.asarray(ep), np.asarray(ref)


def _moe_got(worlds, n, cf):
    return np.concatenate([r["moe", cf] for r in worlds[n]])


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("n", WORLDS)
def test_moe_apply_ep_matches_jax(worlds, n, cf):
    got = _moe_got(worlds, n, cf)
    ep, ref = _jax_moe(n, cf)
    np.testing.assert_allclose(got, ep, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_moe_capacity_drop(worlds, n):
    dropped = _moe_got(worlds, n, 0.2)
    zero_rows = np.all(dropped == 0, axis=1)
    assert zero_rows.any() and not zero_rows.all()
    np.testing.assert_allclose(dropped, _jax_moe(n, 0.2)[0], atol=2e-5,
                               rtol=2e-5)
    assert not np.all(_moe_got(worlds, n, 16.0) == 0, axis=1).any()


@pytest.mark.parametrize("n", WORLDS)
def test_moe_train_step_matches_jax(worlds, n):
    data = _inputs()[n]
    new, loss = jmoe.make_moe_train_step(_mesh(n, ("ep",)), _moe_cfg(n),
                                         lr=worker.MOE_LR)(
        data["moe_params"], data["moe_x"])
    new = _np(new)
    for r, res in enumerate(worlds[n]):
        got_loss, (w1, w2, wr) = res["moe_train"]
        assert got_loss == pytest.approx(float(loss), rel=1e-5)
        np.testing.assert_allclose(wr, new["wr"], atol=1e-5)
        np.testing.assert_allclose(w1, new["w1"][r:r + 1], atol=1e-5)
        np.testing.assert_allclose(w2, new["w2"][r:r + 1], atol=1e-5)
    assert not np.allclose(new["w1"], data["moe_params"]["w1"])


# ------------------------------------------------------ tensor parallel
@lru_cache(maxsize=None)
def _jax_tp(n, dp, tp, kv):
    data = _inputs()[n]["tp", kv]
    cfg = _jcfg(kv_heads=kv)
    mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("dp", "tp"))
    p, x = jtfm.place(data["params"], data["x"], mesh, cfg)
    new, loss = jtfm.make_sharded_train_step(mesh, cfg, lr=worker.TP_LR)(p, x)
    return _np(new), float(loss)


@pytest.mark.parametrize("n,dp,tp,kv", [(n, *c) for n in WORLDS
                                        for c in worker.TP_CASES[n]])
def test_sharded_train_step_matches_jax(worlds, n, dp, tp, kv):
    want, want_loss = _jax_tp(n, dp, tp, kv)
    cfg = tfm.TransformerConfig(batch=4, kv_heads=kv, **worker.TFM)
    runs = [r["tp", dp, tp, kv] for r in worlds[n]]
    for loss, _ in runs:
        assert loss == pytest.approx(want_loss, rel=1e-5)
    for i in range(dp):  # every dp replica holds the same parameters
        shards = [{k: tuple(map(torch.from_numpy, v)) if isinstance(v, list)
                   else torch.from_numpy(v) for k, v in runs[i * tp + j][1]
                   .items()} for j in range(tp)]
        got = tfm.tp_gather(shards, cfg)
        for g, w in zip(tfm.leaves(got), tfm.leaves(want), strict=True):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    assert not np.allclose(want["wqkv"], _inputs()[n]["tp", kv]["params"][
        "wqkv"])


# ----------------------------------------------------- pipeline parallel
@lru_cache(maxsize=None)
def _jax_pp(n, m):
    data = _inputs()[n]["pp", m]
    cfg = jtfm.TransformerConfig(batch=2 * m, attention="xla",
                                 **worker.PP_TFM)
    new, loss = jtfm.make_pipeline_train_step(
        _mesh(n, ("pp",)), cfg, n_microbatches=m, lr=worker.PP_LR)(
        data["params"], data["x"])

    def seq_loss(stacked):
        out = data["x"]
        for i in range(n):
            out = jtfm.block_apply(jax.tree.map(lambda t: t[i], stacked),
                                   out, cfg)
        return jnp.mean(jnp.square(out.astype(jnp.float32)))

    seq, g = jax.value_and_grad(seq_loss)(data["params"])
    seq_p = jax.tree.map(lambda w, gw: w - worker.PP_LR * gw, data["params"],
                         g)
    return (_np(new), float(loss)), (_np(seq_p), float(seq))


@pytest.mark.parametrize("n,m", [(n, m) for n in WORLDS
                                 for m in worker.PP_MICROBATCHES[n]])
def test_pipeline_train_step_matches_jax(worlds, n, m):
    for want, want_loss in _jax_pp(n, m):
        for s, res in enumerate(worlds[n]):
            loss, leaves = res["pp", m]
            assert loss == pytest.approx(want_loss, rel=1e-5)
            stage = tfm.leaves(jax.tree.map(lambda t: t[s], want))
            for g, w in zip(leaves, stage, strict=True):
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------------- MLP
@lru_cache(maxsize=None)
def _jax_mlp(n, dp, tp):
    """Dry-run path 5's program (``__graft_entry__.py:169-215``) at (dp,
    tp) on the world of n's inputs."""
    data = _inputs()[n]["mlp"]
    mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("dp", "tp"))
    mp = [(jax.device_put(w, NamedSharding(
               mesh, P(None, "tp") if w.shape[1] > 1 else P(None, None))),
           jax.device_put(b, NamedSharding(
               mesh, P("tp") if b.shape[0] > 1 else P(None))))
          for w, b in data["params"]]
    xb = jax.device_put(data["x"], NamedSharding(mesh, P("dp", None)))
    yb = jax.device_put(data["y"], NamedSharding(mesh, P("dp")))

    @jax.jit
    def tp_step(mp, x, y):
        def loss_fn(mp):
            logits = jmlp.mlp_forward(mp, x)[:, 0]
            return jnp.mean((logits - y) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(mp)
        return jax.tree.map(lambda p, gg: p - worker.MLP_LR * gg, mp, g), loss

    new, loss = tp_step(mp, xb, yb)
    return _np(new), float(loss)


@pytest.mark.parametrize("n,dp,tp", [(n, *c) for n in WORLDS
                                     for c in worker.MLP_MESHES[n]])
def test_tp_mlp_step_matches_path_5(worlds, n, dp, tp):
    want, want_loss = _jax_mlp(n, dp, tp)
    runs = [r["mlp", dp, tp] for r in worlds[n]]
    for loss, _ in runs:
        assert loss == pytest.approx(want_loss, rel=1e-5)
    for i in range(dp):
        per = [runs[i * tp + j][1] for j in range(tp)]
        for layer, (w, b) in enumerate(want):
            cat = w.shape[1] > 1
            gw = (np.concatenate([p[layer][0] for p in per], axis=1) if cat
                  else per[0][layer][0])
            gb = (np.concatenate([p[layer][1] for p in per]) if cat
                  else per[0][layer][1])
            np.testing.assert_allclose(gw, w, rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(gb, b, rtol=1e-5, atol=1e-8)


# -------------------------------------------------------------- ring hop
@pytest.mark.parametrize("n", WORLDS)
def test_ring_hop_and_its_backward(worlds, n):
    for r, res in enumerate(worlds[n]):
        got, grad = res["hop"]
        np.testing.assert_array_equal(got, np.full(3, (r - 1) % n))
        np.testing.assert_array_equal(grad, np.full(3, 10.0 + (r + 1) % n))


# ------------------------------------------------------- single process
def test_merge_matches_jax():
    rng = _rng(0)
    b, h, s, d = 2, 3, 16, 8
    o, o_t = (rng.standard_normal((b, h, s, d)).astype(np.float32)
              for _ in range(2))
    lse, lse_t = (rng.standard_normal((b, h, s)).astype(np.float32)
                  for _ in range(2))
    lanes = [np.broadcast_to(t.reshape(b * h, s, 1), (b * h, s, 128))
             for t in (lse, lse_t)]
    want_o, want_lse = jmerge(o, lanes[0], o_t, lanes[1])
    got_o, got_lse = merge(*map(torch.from_numpy, (o, lse, o_t, lse_t)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy().reshape(b * h, s),
                               np.asarray(want_lse)[:, :, 0], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_schedule_over_in_process_shards(causal):
    """The one-card schedule of ``chip_smoke.py`` phase 21: each rank's
    steps fed the shards in ring order, in one process."""
    q, k, v = _inputs()[4]["ring", (causal, 64, 128)]
    n, s = 4, 128
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ks = [tk[:, :, i * s:(i + 1) * s] for i in range(n)]
    vs = [tv[:, :, i * s:(i + 1) * s] for i in range(n)]
    got = torch.cat([ring_attention_steps(
        tq[:, :, r * s:(r + 1) * s],
        ((ks[(r - t) % n], vs[(r - t) % n]) for t in range(n)), r, n,
        causal=causal) for r in range(n)], dim=2)
    np.testing.assert_allclose(got.numpy(), _jax_ring(4, (causal, 64, 128))[1],
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("kv,tp", [(None, 1), (None, 2), (None, 4), (2, 2)])
def test_tp_shard_and_gather_round_trip(kv, tp):
    cfg = tfm.TransformerConfig(batch=4, kv_heads=kv, **worker.TFM)
    full = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    shards = [tfm.tp_shard(full, cfg, r, tp) for r in range(tp)]
    e, d, kvh = cfg.emb, cfg.head_dim, cfg.kvh
    for r, sh in enumerate(shards):  # rank r's q heads, then its kv heads
        qc, kc = e // tp, kvh * d // tp
        torch.testing.assert_close(sh["wqkv"][:, :qc],
                                   full["wqkv"][:, r * qc:(r + 1) * qc])
        torch.testing.assert_close(
            sh["wqkv"][:, qc:qc + kc],
            full["wqkv"][:, e + r * kc:e + (r + 1) * kc])
        assert sh["w1"].shape == (e, cfg.ffn // tp)
    for g, w in zip(tfm.leaves(tfm.tp_gather(shards, cfg)), tfm.leaves(full),
                    strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_tp_shard_refuses_kv_heads_tp_does_not_divide():
    cfg = tfm.TransformerConfig(batch=4, kv_heads=2, **worker.TFM)
    full = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="kv heads"):
        tfm.tp_shard(full, cfg, 0, 4)
    with pytest.raises(ValueError, match="the width"):
        mlp_tp_shard([(torch.zeros(4, 6), torch.zeros(6))], 0, 4)


def test_moe_reference_matches_jax():
    data = _inputs()[2]
    cfg = moe.MoeConfig(worker.MOE["emb"], worker.MOE["ffn"], 2)
    got = moe.moe_apply_reference(
        convert.moe_params_from_jax(data["moe_params"], "cpu"),
        torch.from_numpy(data["moe_x"]), cfg, n_senders=2)
    np.testing.assert_allclose(got.numpy(), _jax_moe(2, 1.25)[1], atol=2e-5,
                               rtol=2e-5)


def test_stage_params_from_jax_slice_the_stack():
    stacked = _inputs()[2]["pp", 2]["params"]
    for s in range(2):
        got = convert.stage_params_from_jax(stacked, s, "cpu")
        for g, w in zip(tfm.leaves(got), tfm.leaves(jax.tree.map(
                lambda t: t[s], stacked)), strict=True):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.fixture
def world1():
    b = DistBackend("cpu")
    b.initialize()
    yield b
    b.shutdown()


def test_world_of_one_tp_step_equals_single_device(world1):
    """``experiments.parallel_tier``'s checks run as ``chip_smoke.py`` phase
    21 runs them, in a world of one (here on the CPU)."""
    cfg = tfm.TransformerConfig(batch=2, **worker.PP_TFM)
    rec = parallel_tier.check_tp(world1, 1, 1, cfg, "cpu", param_rtol=1e-5)
    assert rec["losses"] == pytest.approx(rec["oracle_losses"], rel=1e-5)


def test_world_of_one_pipeline_equals_single_device(world1):
    cfg = tfm.TransformerConfig(batch=4, **worker.PP_TFM)
    rec = parallel_tier.check_pp(world1.get_default_group(), cfg, 4, "cpu",
                                 loss_rtol=1e-5)
    assert rec["max_param_err"] <= 1e-6


def test_world_of_one_moe_equals_reference(world1):
    rec = parallel_tier.check_moe(world1.get_default_group(),
                                  moe.MoeConfig(16, 32, 1), 64, "cpu",
                                  loss_rtol=1e-5)
    assert rec["max_abs_err"] <= 2e-5


def test_world_of_one_mlp_step_equals_single_device(world1):
    rec = parallel_tier.check_mlp(world1, 1, 1, [16, 32, 8, 1], 64, "cpu",
                                  param_rtol=1e-5)
    assert rec["max_param_err"] == 0.0


def test_world_of_one_ring_equals_flash(world1):
    rec = parallel_tier.check_ring(world1.get_default_group(), (1, 2, 64, 32),
                                   torch.float32, "cpu")
    assert rec["max_abs_err"] == 0.0
