"""The port's dedup and sparse row update (K2 and its plain version) against
the reference's ``dedup_row_updates`` and ``sparse_row_update`` (the Pallas
kernel in interpret mode).

f32 tolerance rtol=1e-5, atol=1e-6; segment sums of duplicate rows are
taken in another order, so those compare with rtol=1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.ops.sparse_update import (
    adagrad_factor as jax_adagrad_factor,
    dedup_row_updates as jax_dedup,
    pack_rows_to_lanes,
    sparse_row_update as jax_sparse_row_update,
)
from param_tpu_torch.kernels.sparse_update import (
    sparse_update_cuda,
)
from param_tpu_torch.ops.sparse_update import (
    adagrad_factor, dedup_row_updates, sparse_row_update,
)


@pytest.mark.parametrize("num_rows,n", [(1000, 256), (7, 300), (1, 64)],
                         ids=["sparse", "heavy_duplicates", "all_same"])
def test_dedup_matches_jax(num_rows, n):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, num_rows, size=(n,)).astype(np.int32)
    g = rng.standard_normal((n, 8)).astype(np.float32)
    want_rows, want_tot = jax_dedup(jnp.asarray(idx), jnp.asarray(g), 12345)
    rows, tot = dedup_row_updates(torch.from_numpy(idx), torch.from_numpy(g),
                                  12345)
    assert rows.dtype == torch.int32 and rows.shape == (n,)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_allclose(tot.numpy(), np.asarray(want_tot), rtol=1e-4,
                               atol=1e-5)
    n_unique = len(np.unique(idx))
    assert (rows.numpy()[n_unique:] == 12345).all()
    assert not tot.numpy()[n_unique:].any()


def test_adagrad_factor_matches_jax():
    a = np.array([0.0, 1e-9, 0.1, 4.0, 1e4], np.float32)
    want = np.asarray(jax_adagrad_factor(jnp.asarray(a), 1e-7))
    got = adagrad_factor(torch.from_numpy(a), 1e-7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0  # gated: no update while the accumulator is zero


def _update_inputs(R, D, n_valid, n_drop, seed=0, acc0=0.1):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, D)).astype(np.float32)
    acc = np.full((R, D), acc0, np.float32)
    ids = rng.permutation(R)[:n_valid]
    # dropped slots carry ids >= R, as dedup's tail does
    idx = np.concatenate([ids, R + rng.integers(0, 5, n_drop)]).astype(np.int32)
    upd = rng.standard_normal((n_valid + n_drop, D)).astype(np.float32)
    if acc0 == 0.0:
        upd[:3] = 0.0  # a zero gradient on a zero accumulator stays put
    return table, acc, idx, upd


@pytest.mark.parametrize("acc0", [0.1, 0.0])
@pytest.mark.parametrize("mode", ["sgd", "adagrad"])
def test_sparse_row_update_matches_pallas(mode, acc0):
    R, D = 256, 128
    table, acc, idx, upd = _update_inputs(R, D, 100, 20, acc0=acc0)
    lr, eps = 0.05, 1e-7
    j_acc = jnp.asarray(acc) if mode == "adagrad" else None
    want = jax_sparse_row_update(jnp.asarray(table), jnp.asarray(idx),
                                 jnp.asarray(upd), j_acc, lr=lr, eps=eps)
    t = torch.from_numpy(table.copy())
    a = torch.from_numpy(acc.copy()) if mode == "adagrad" else None
    got = sparse_row_update(t, torch.from_numpy(idx), torch.from_numpy(upd),
                            a, lr=lr, eps=eps)
    if mode == "sgd":
        assert got is t  # in place
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    else:
        assert got[0] is t and got[1] is a
        np.testing.assert_allclose(t.numpy(), np.asarray(want[0]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(a.numpy(), np.asarray(want[1]), rtol=1e-5,
                                   atol=1e-6)
    untouched = np.setdiff1d(np.arange(R), idx)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    if acc0 == 0.0 and mode == "adagrad":
        np.testing.assert_array_equal(t.numpy()[idx[:3]], table[idx[:3]])
        np.testing.assert_array_equal(a.numpy()[idx[:3]], 0.0)


@pytest.mark.parametrize("mode", ["sgd", "adagrad"])
def test_narrow_rows_match_lane_packed_pallas(mode):
    """D=16: the port updates (R, 16) rows directly; the reference repacks
    them into 128-lane rows first.  Same result."""
    R, D = 512, 16
    table, acc, idx, upd = _update_inputs(R, D, 200, 30, seed=1)
    order = np.argsort(idx, kind="stable")  # pack_rows_to_lanes wants sorted
    idx, upd = idx[order], upd[order]
    lr, eps = 0.05, 1e-7
    prow, ptot, pR = pack_rows_to_lanes(jnp.asarray(idx), jnp.asarray(upd), R)
    j_tab = jnp.asarray(table).reshape(pR, -1)
    if mode == "sgd":
        want = np.asarray(jax_sparse_row_update(j_tab, prow, ptot)).reshape(R, D)
    else:
        wt, wa = jax_sparse_row_update(j_tab, prow, ptot,
                                       jnp.asarray(acc).reshape(pR, -1),
                                       lr=lr, eps=eps)
        want = np.asarray(wt).reshape(R, D)
        want_acc = np.asarray(wa).reshape(R, D)
    t = torch.from_numpy(table.copy())
    a = torch.from_numpy(acc.copy()) if mode == "adagrad" else None
    sparse_row_update(t, torch.from_numpy(idx), torch.from_numpy(upd), a,
                      lr=lr, eps=eps)
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-5, atol=1e-6)
    if mode == "adagrad":
        np.testing.assert_allclose(a.numpy(), want_acc, rtol=1e-5, atol=1e-6)


def test_cuda_wrapper_checks_inputs():
    table, acc, idx, upd = _update_inputs(64, 8, 10, 2)
    t, i, u = map(torch.from_numpy, (table, idx, upd))
    with pytest.raises(TypeError):
        sparse_update_cuda(t, i.long(), u)
    with pytest.raises(ValueError):
        sparse_update_cuda(t, i, u[:5])
    with pytest.raises(TypeError):
        sparse_update_cuda(t.double(), i, u.double())

