"""The coalesced-fetch experiment's port (K9, K10) against the reference
script ``scripts/coalesce_experiment.py``, whose Pallas kernels run in
interpret mode on the CPU.  No reference test imports the script, so it is
loaded here with importlib.

Tolerances are the script's own (``verify()``): K9 rtol 1e-4 (tile sums of
up to 1024 rows taken in another order), K10 rtol 1e-5 (bags of 8 rows
summed in sorted order where the reference sums in bag order).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu_torch.experiments import coalesce as port
from param_tpu_torch.kernels import coalesce as kc
from param_tpu_torch.kernels.emb_gather import emb_gather_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_SMALL = 4096  # verify()'s table rows; D is the script's fixed 128


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "coalesce_experiment", os.path.join(ROOT, "scripts",
                                            "coalesce_experiment.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(seed=1):
    rng = np.random.default_rng(seed)
    return rng, rng.random((E_SMALL, port.D), dtype=np.float32)


@pytest.mark.parametrize("k,n_starts", [(8, 512), (1, 2048), (32, 64)],
                         ids=["verify-k8", "k1", "k32"])
def test_desc_fetch_matches_reference(ref, k, n_starts):
    """verify()'s case (4 tiles of 128 starts, k 8) and two tiles at k 1
    and 32, rows_per_tile 1024."""
    rng, table = _table()
    starts = rng.integers(0, E_SMALL - k, size=(n_starts,)).astype(np.int32)
    want = np.asarray(ref.desc_fetch(jnp.asarray(table), jnp.asarray(starts),
                                     k=k, rows_per_tile=1024))
    got = kc.desc_fetch(torch.from_numpy(table), torch.from_numpy(starts),
                          k, rows_per_tile=1024)
    assert got.shape == want.shape == (n_starts * k // 1024, port.D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("case,r_blk", [("verify", 8), ("dup64", 8),
                                        ("dup64", 1), ("dup64", 16)])
def test_coalesced_bag_matches_reference(ref, case, r_blk):
    """verify()'s ids (64 bags x 8 over 4096 rows), and ids drawn from 64
    rows only, so that most blocks repeat within a tile (the pre-pass's
    dedup and slot arithmetic at work)."""
    rng, table = _table()
    if case == "verify":
        idx = rng.integers(0, E_SMALL, size=(64, 8)).astype(np.int32)
    else:
        pool = rng.choice(E_SMALL, size=64, replace=False)
        idx = pool[rng.integers(0, 64, size=(64, 8))].astype(np.int32)
    want = np.asarray(ref.coalesced_bag(jnp.asarray(table), jnp.asarray(idx),
                                        r_blk=r_blk, tile_bags=16))
    got = kc.coalesced_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             r_blk=r_blk, tile_bags=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), table[idx].sum(1), rtol=1e-5)


def _check_plan(idx, rows, r_blk, tile_bags):
    """Each tile's block list is its distinct aligned blocks in ascending
    order; each sorted id's slot and offset point back at the id; the
    order is a permutation of the tile."""
    plan = kc.coalesce_plan(torch.from_numpy(idx), rows, r_blk, tile_bags)
    rpt = tile_bags * idx.shape[1]
    tiles = idx.reshape(-1, rpt)
    for t in range(tiles.shape[0]):
        want_blocks = np.unique(tiles[t] // r_blk) * r_blk
        nb = int(plan.n_blocks[t])
        assert nb == len(want_blocks)
        np.testing.assert_array_equal(plan.blocks[t, :nb].numpy(), want_blocks)
        flat = plan.flat[t].numpy()
        rows_got = plan.blocks[t].numpy()[flat // r_blk] + flat % r_blk
        order = plan.order[t].numpy()
        np.testing.assert_array_equal(np.sort(order), np.arange(rpt))
        np.testing.assert_array_equal(rows_got, tiles[t][order])
        assert (np.diff(flat) >= 0).all()


@pytest.mark.parametrize("r_blk", [1, 3, 8])
def test_plan_addresses_every_id(r_blk):
    rng = np.random.default_rng(r_blk)
    idx = rng.integers(0, 100, size=(32, 5)).astype(np.int32)
    _check_plan(idx, 100, r_blk, tile_bags=8)


@pytest.mark.parametrize("r_blk", [1, 8, 16])
def test_plan_under_heavy_duplication(r_blk):
    """The pre-pass at the reference test's dup64 ids (64 bags x 8 drawn
    from 64 rows of 4096, 16 bags a tile): most blocks repeat in a tile."""
    rng, _ = _table()
    pool = rng.choice(E_SMALL, size=64, replace=False)
    idx = pool[rng.integers(0, 64, size=(64, 8))].astype(np.int32)
    _check_plan(idx, E_SMALL, r_blk, tile_bags=16)


def test_coalesced_bag_takes_ids_as_k1_does():
    """An id in [-R, 0) counts from the end; any other id outside [0, R)
    makes its bag NaN, as in K1."""
    rng, table = _table(2)
    idx = rng.integers(0, E_SMALL, size=(32, 4)).astype(np.int32)
    idx[0, 1], idx[5, 0], idx[17, 3] = -3, E_SMALL, -E_SMALL - 1
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    got = kc.coalesced_bag(t, i, r_blk=8, tile_bags=16)
    want = emb_gather_plain(t, i)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    assert torch.isnan(got[[5, 17]]).all() and torch.isfinite(got[0]).all()


def test_desc_fetch_start_out_of_range_makes_its_tile_nan():
    _, table = _table()
    starts = np.arange(0, 256, 2, dtype=np.int32)  # 2 tiles of 64 at k 4
    starts[70] = E_SMALL - 3
    got = kc.desc_fetch(torch.from_numpy(table), torch.from_numpy(starts),
                          4, rows_per_tile=256)
    assert torch.isfinite(got[0]).all() and torch.isnan(got[1]).all()


@pytest.mark.parametrize("call", [
    lambda t: kc.desc_fetch(t, torch.zeros(96, dtype=torch.int32), 3,
                              rows_per_tile=256),
    lambda t: kc.desc_fetch(t, torch.zeros(100, dtype=torch.int32), 4,
                              rows_per_tile=256),
    lambda t: kc.coalesced_bag(t, torch.zeros((20, 4), dtype=torch.int32)),
], ids=["k-not-dividing-tile", "ragged-tiles", "ragged-bag-tiles"])
def test_shapes_the_reference_cannot_take_raise(call):
    with pytest.raises(ValueError):
        call(torch.zeros((64, port.D)))


def test_experiment_main_on_cpu(capsys):
    assert port.main(["--device", "cpu", "--num-rows", "4096", "--batch",
                      "64", "--rows-per-tile", "1024", "--iters", "2"]) == 0
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines()
                if ln.strip().startswith("K=")]) == len(port.KS)
    verdicts = [ln for ln in out.splitlines() if " -> " in ln]
    assert len(verdicts) == 2 and all(("WIN" in ln) != ("LOSS" in ln)
                                      for ln in verdicts)
    assert port.main(["--verify", "--device", "cpu"]) == 0
    assert "verify: both kernels match" in capsys.readouterr().out


def test_experiment_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.main(["--verify"])
