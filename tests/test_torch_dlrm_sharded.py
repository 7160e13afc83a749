"""The port's table-wise sharded DLRM against the reference's sharded
programs: ranks of spawned gloo worlds of 2 and 4 (tests/torch_dlrm_worker.py,
no JAX in the children) against ``param_tpu``'s ``shard_map`` programs on a
CPU mesh of the same size, fed the same full parameters and batches.

Compared: the sharded loss; value and grad (dense grads, and the table
grads of the ranks in rank order); losses, parameters and accumulators
after two steps of dense sgd, dense adagrad, sparse_sgd and sparse_adagrad
(the reference's sparse steps on ``table_update="pallas"``, its Pallas
kernel in interpret mode); the ragged loss with full and variable (0..nnz)
lengths on both wires; ``ragged_sparse_dist`` against ``ragged_reference``.
Then the comm bench's regions, report rows, payload bytes and comm pattern
against the reference's, the CLI's default bench and ``--print-comms`` on
the CPU, and the sharded trainer under ``torchrun``.

Tolerance: f32 rtol 1e-5, atol 1e-6 (atol 1e-5 where logits of magnitude
about 1 are compared: the losses); the ragged exchange's ids exactly.
"""

import json
import math
import os
import pickle
import re
import socket
import subprocess
import sys
from functools import lru_cache

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from param_tpu.models import dlrm as jdlrm
from param_tpu.models import dlrm_bench as jbench
from param_tpu.models.dlrm_data import RandomDataset
from param_tpu.models.ragged import ragged_reference as jax_ragged_reference
from param_tpu_torch.backend import DistBackend
from param_tpu_torch.cli import dlrm as cli
from param_tpu_torch.models import dlrm_bench
from param_tpu_torch.models.convert import (
    adagrad_state_shard_from_jax, params_shard_from_jax,
)
from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
from param_tpu_torch.models.ragged import ragged_reference

import torch_dlrm_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 120
WORLDS = (2, 4)
TINY = dict(num_tables=4, rows_per_table=512, emb_dim=16, nnz=4, dense_dim=16,
            bot_mlp=[32, 16], top_mlp=[32, 1], batch=64)
TINY_FLAGS = ["--num-tables", "4", "--rows", "512", "--emb-dim", "16",
              "--nnz", "4", "--dense-dim", "16", "--arch-mlp-bot", "32-16",
              "--arch-mlp-top", "32-1", "--batch", "64"]
LR = worker.LR


def _flat(tree):
    out = [tree["tables"]]
    for key in ("bot", "top"):
        for w, b in tree[key]:
            out += [w, b]
    return [np.asarray(t) for t in out]


def _close(got, want, atol=1e-6):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol)


def _gather_tables(per_rank):
    """Each rank's leaves (tables first) -> the leaves with the tables
    concatenated in rank order, and the MLP leaves of rank 0, which every
    rank must hold equally."""
    for r in per_rank[1:]:
        _close(r[1:], per_rank[0][1:])
    return [np.concatenate([r[0] for r in per_rank])] + list(per_rank[0][1:])


# ------------------------------------------------------------ the inputs
@lru_cache(maxsize=None)
def _inputs():
    cfg = jdlrm.DlrmConfig(**TINY)
    jparams = jdlrm.init_dlrm_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(np.asarray, jparams)
    batches = list(RandomDataset(batch=64, dense_dim=16, num_tables=4, nnz=4,
                                 num_rows=512, num_batches=2))
    rng = np.random.default_rng(5)
    lengths = {"full": np.full((64, 4), 4, np.int32),
               "variable": rng.integers(0, 5, size=(64, 4)).astype(np.int32)}
    ragged = dict(params, tables=np.concatenate(
        [params["tables"], np.zeros((4, 1, 16), np.float32)], axis=1))
    return dict(cfg=TINY, params=params, batches=batches, lengths=lengths,
                ragged_params=ragged)


@lru_cache(maxsize=None)
def _jax_model(n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    return jdlrm.DlrmModel(jdlrm.DlrmConfig(**TINY), mesh)


def _placed(n):
    model = _jax_model(n)
    data = _inputs()
    p, b = model.place(data["params"], data["batches"][0])
    return model, p, b


# --------------------------------------------------------- spawned worlds
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results, both worlds run at once."""
    base = tmp_path_factory.mktemp("dlrm_worlds")
    in_file = str(base / "inputs.pkl")
    with open(in_file, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs, dirs = {}, {}
    for n in WORLDS:
        dirs[n] = str(base / f"world{n}")
        os.makedirs(dirs[n])
        procs[n] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dlrm_worker.py"),
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


# ------------------------------------------------------ model parity
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_loss_matches_jax(worlds, n):
    model, p, b = _placed(n)
    want = float(model.make_sharded_loss()(p, *b))
    for r in worlds[n]:
        np.testing.assert_allclose(r["loss"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_value_and_grad_matches_jax(worlds, n):
    model, p, b = _placed(n)
    loss, grads = jax.jit(model.make_value_and_grad())(p, *b)
    for r in worlds[n]:
        np.testing.assert_allclose(r["vg"][0], float(loss), rtol=1e-5,
                                   atol=1e-5)
    got = _gather_tables([r["vg"][1] for r in worlds[n]])
    _close(got, _flat(jax.tree.map(np.asarray, grads)))


@lru_cache(maxsize=None)
def _jax_train(n, opt_name):
    model, p, _ = _placed(n)
    batches = _inputs()["batches"]
    losses, acc = [], None
    if opt_name in ("sgd", "adagrad"):
        opt = optax.sgd(LR) if opt_name == "sgd" else optax.adagrad(LR)
        step = model.make_train_step(opt)
        st = opt.init(p)
        for b in batches:
            p, st, loss = step(p, st, *model.place_batch(b))
            losses.append(float(loss))
        acc = st[0].sum_of_squares if opt_name == "adagrad" else None
    elif opt_name == "sparse_sgd":
        step = model.make_sparse_sgd_step(LR, table_update="pallas")
        for b in batches:
            p, loss = step(p, *model.place_batch(b))
            losses.append(float(loss))
    else:
        step = model.make_sparse_adagrad_step(LR, table_update="pallas")
        acc = model.init_adagrad_state(p)
        for b in batches:
            p, acc, loss = step(p, acc, *model.place_batch(b))
            losses.append(float(loss))
    return (losses, _flat(jax.tree.map(np.asarray, p)),
            None if acc is None else _flat(jax.tree.map(np.asarray, acc)))


@pytest.mark.parametrize("opt_name", worker.OPTIMIZERS)
@pytest.mark.parametrize("n", WORLDS)
def test_two_steps_match_jax(worlds, n, opt_name):
    want_losses, want_p, want_acc = _jax_train(n, opt_name)
    runs = [r[f"train:{opt_name}"] for r in worlds[n]]
    for losses, _, _ in runs:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    _close(_gather_tables([p for _, p, _ in runs]), want_p)
    if want_acc is not None:
        _close(_gather_tables([a for _, _, a in runs]), want_acc)
    # the tables moved: the steps really trained them
    assert not np.allclose(want_p[0], _inputs()["params"]["tables"])


@lru_cache(maxsize=None)
def _jax_ragged_loss(n, name):
    data = _inputs()
    dense, idx, labels = data["batches"][0]
    fn = _jax_model(n).make_sharded_loss_ragged()
    return float(fn(data["ragged_params"], dense, data["lengths"][name], idx,
                    labels))


@pytest.mark.parametrize("wire", worker.WIRES)
@pytest.mark.parametrize("name", ["full", "variable"])
@pytest.mark.parametrize("n", WORLDS)
def test_ragged_loss_matches_jax(worlds, n, name, wire):
    want = _jax_ragged_loss(n, name)
    for r in worlds[n]:
        np.testing.assert_allclose(r[f"ragged_loss:{name}:{wire}"], want,
                                   rtol=1e-5, atol=1e-5)
    if name == "full":  # full bags: the fixed-nnz loss
        np.testing.assert_allclose(want, worlds[n][0]["loss"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("wire", worker.WIRES)
@pytest.mark.parametrize("n", WORLDS)
def test_ragged_sparse_dist_matches_reference(worlds, n, wire):
    data = _inputs()
    lengths, idx = data["lengths"]["variable"], data["batches"][0][1]
    want = ragged_reference(lengths, idx, n, pad_row=512)
    for (lt_w, it_w), (lt_j, it_j) in zip(
            want, jax_ragged_reference(lengths, idx, n, 512)):
        np.testing.assert_array_equal(lt_w, lt_j)
        np.testing.assert_array_equal(it_w, it_j)
    for r, (lt, it) in zip(worlds[n], want, strict=True):
        got_lt, got_it = r[f"ragged_dist:variable:{wire}"]
        np.testing.assert_array_equal(got_lt, lt)
        np.testing.assert_array_equal(got_it, it)


# ------------------------------------------------------------- the bench
def test_regions_and_ref_rows_match_jax():
    assert dlrm_bench.REGIONS == jbench.REGIONS
    assert dlrm_bench.REF_ROWS == jbench.REF_ROWS
    assert len([r for r in dlrm_bench.REF_ROWS]) == 21


@pytest.fixture
def world1():
    b = DistBackend("cpu")
    b.initialize()
    yield b
    b.shutdown()


@pytest.mark.parametrize("n", (1,) + WORLDS)
def test_bench_pattern_and_memory_match_jax(n, worlds, world1):
    want = jbench.DlrmCommBench(_jax_model(n), optax.adagrad(LR))
    if n == 1:
        model = DlrmModel(DlrmConfig(**TINY), group=world1.get_default_group(),
                          device="cpu")
        bench = dlrm_bench.DlrmCommBench(model, "sparse_sgd")
        got = [(bench.comms_trace(), bench.region_memory_bytes())]
    else:
        got = [(r["comms_trace"], r["memory"]) for r in worlds[n]]
    for trace, memory in got:
        assert trace == want.comms_trace()
        assert memory == want.region_memory_bytes()


@pytest.mark.parametrize("opt", ["adagrad", "sparse_adagrad"])
@pytest.mark.parametrize("n", WORLDS)
def test_bench_runs_every_region_in_world(worlds, n, opt):
    for r in worlds[n]:
        res = r[f"bench:{opt}"]
        assert set(dlrm_bench.REGIONS) <= set(res)
        for ref_name, key, parts in dlrm_bench.REF_ROWS:
            row = res[ref_name if parts else key]
            assert all(math.isfinite(row[k]) and row[k] > 0
                       for k in ("min_us", "p50_us", "p75_us", "p95_us"))
        assert res["_summary"]["world"] == n and res["_summary"]["qps"] > 0
    # the samples are pooled over the ranks: every rank reports the same
    assert all(r[f"bench:{opt}"]["step_total"] ==
               worlds[n][0][f"bench:{opt}"]["step_total"] for r in worlds[n])


_ROW = re.compile(r"^\s*(\S+)\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)\s+"
                  r"([\d.]+)\s+([\d.]+)$", re.M)


@pytest.mark.parametrize("optimizer", ["adagrad", "sparse_adagrad"])
def test_cli_default_bench_on_cpu(optimizer, capsys):
    rc = cli.main(TINY_FLAGS + ["--device", "cpu", "--optimizer", optimizer,
                                "--reps", "2", "--chain", "2",
                                "--max-chain", "4", "--log", "WARNING"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "DLRM-RES world=1 batch=64 tables=4x512x16 nnz=4" in out
    rows = {m.group(1): [float(v) for v in m.groups()[2:6]]
            for m in _ROW.finditer(out)}
    assert set(rows) == {name for name, _, _ in dlrm_bench.REF_ROWS}
    assert all(math.isfinite(v) and v > 0 for vs in rows.values() for v in vs)
    qps = re.findall(r"^QPS: (\S+)$", out, re.M)
    assert len(qps) == 1 and float(qps[0]) > 0


def test_cli_print_comms_matches_jax_cli(tmp_path, monkeypatch):
    from param_tpu.cli import dlrm as jcli

    flags = TINY_FLAGS + ["--optimizer", "sparse_sgd"]
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    assert cli.main(flags + ["--device", "cpu", "--print-comms",
                             str(got)]) == 0
    one = jax.devices()[:1]  # the same world as the port's: one rank
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    assert jcli.main(flags + ["--print-comms", str(want)]) == 0
    assert json.loads(got.read_text()) == json.loads(want.read_text())
    assert len(json.loads(got.read_text())) == 5


def test_regions_flag_and_unknown_region(capsys):
    cli.main(TINY_FLAGS + ["--device", "cpu", "--regions",
                           "idx_xchg,fwd_a2a", "--reps", "1", "--chain", "1",
                           "--max-chain", "1", "--log", "WARNING"])
    out = capsys.readouterr().out
    assert {m.group(1) for m in _ROW.finditer(out)} == {"idx_xchg", "fwd_a2a"}
    with pytest.raises(ValueError, match="unknown regions"):
        cli.main(TINY_FLAGS + ["--device", "cpu", "--regions", "nope"])


def test_cli_bench_profile_writes_a_trace(tmp_path, capsys):
    assert cli.main(TINY_FLAGS + ["--device", "cpu", "--regions",
                                  "step_total", "--reps", "1", "--chain", "1",
                                  "--max-chain", "1", "--profile",
                                  str(tmp_path), "--log", "WARNING"]) == 0
    out = capsys.readouterr().out
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert "device time not measured" in out and "iter_time" in out


def test_cli_torchrun_world_of_2_trains(capsys):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), "-m",
           "param_tpu_torch.cli.dlrm", "--", "--device", "cpu",
           "--train-batches", "2", "--optimizer", "sparse_adagrad",
           "--log", "WARNING"] + TINY_FLAGS
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=WORLD_TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    sharded = re.findall(r"^batch\s+\d+\s+loss (\S+)$", r.stdout, re.M)
    e2e = [ln for ln in r.stdout.splitlines() if ln.startswith("DLRM-E2E")]
    assert len(sharded) == 2 and len(e2e) == 1, r.stdout  # rank 0 only
    assert "world=2" in e2e[0] and "AUC=" in e2e[0]
    # the same data and full parameters: the single-device run's losses
    assert cli.main(TINY_FLAGS + ["--device", "cpu", "--train-batches", "2",
                                  "--optimizer", "sparse_adagrad"]) == 0
    single = re.findall(r"^batch\s+\d+\s+loss (\S+)$",
                        capsys.readouterr().out, re.M)
    np.testing.assert_allclose([float(x) for x in sharded],
                               [float(x) for x in single], rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ conversion
@pytest.mark.parametrize("n", (1,) + WORLDS)
def test_shards_from_jax_tile_the_full_tree(n):
    params = _inputs()["params"]
    acc = jax.tree.map(lambda a: np.full_like(a, 0.1), params)
    shards = [params_shard_from_jax(params, r, n, "cpu") for r in range(n)]
    accs = [adagrad_state_shard_from_jax(acc, r, n, "cpu") for r in range(n)]
    got = torch.cat([s["tables"] for s in shards]).detach().numpy()
    np.testing.assert_array_equal(got, params["tables"])
    assert all(s["tables"].shape == (4 // n, 512, 16) and
               s["tables"].requires_grad for s in shards)
    assert all(not a["tables"].requires_grad and a["tables"].shape ==
               (4 // n, 512, 16) for a in accs)
    np.testing.assert_array_equal(shards[-1]["top"][0][0].detach().numpy(),
                                  params["top"][0][0])
    with pytest.raises(ValueError, match="do not split"):
        params_shard_from_jax(params, 0, 3, "cpu")


def test_sharded_init_is_the_full_init_sliced(world1):
    full = DlrmModel(DlrmConfig(**TINY), device="cpu").init_params(7)
    model = DlrmModel(DlrmConfig(**TINY), group=world1.get_default_group(),
                      device="cpu")
    p = model.init_params(7)
    torch.testing.assert_close(p["tables"], full["tables"])
    assert all(t.requires_grad for t in [p["tables"]] + list(p["bot"][0]))
