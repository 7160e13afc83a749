"""The port's embedding bag (K1 and its plain version) against the
reference's ``embedding_bag`` / ``embedding_bag_pallas``.

Inputs come from numpy with a fixed seed.  f32 tolerance rtol=1e-5,
atol=1e-6.  bf16 outputs are compared in f32 with rtol=8e-3 (one bf16 ulp),
because the two frameworks may round the f32 sum to bf16 from sums taken in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.ops.embedding import (
    embedding_bag as jax_embedding_bag,
    embedding_bag_grad as jax_embedding_bag_grad,
    embedding_bag_pallas,
    pad_ragged_indices as jax_pad_ragged_indices,
)
from param_tpu_torch.kernels.emb_gather import (
    emb_gather, emb_gather_cuda, emb_gather_plain,
)
from param_tpu_torch.ops.embedding import (
    embedding_bag, embedding_bag_grad, embedding_bytes, pad_ragged_indices,
    with_pad_row,
)


def _inputs(rows=512, dim=16, batch=64, nnz=4, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    idx = rng.integers(0, rows, size=(batch, nnz)).astype(np.int32)
    w = rng.random((batch, nnz)).astype(np.float32)
    return table, idx, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_matches_jax_embedding_bag(dtype, weighted):
    table, idx, w = _inputs()
    jt = jnp.asarray(table).astype(dtype)
    want = jax_embedding_bag(jt, jnp.asarray(idx),
                             jnp.asarray(w) if weighted else None)
    want = np.asarray(want.astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = embedding_bag(tt, torch.from_numpy(idx),
                        torch.from_numpy(w) if weighted else None)
    assert got.dtype == tt.dtype and got.shape == (64, 16)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel(dtype):
    """The TPU kernel in interpret mode, at a lane-wide row (D=128)."""
    table, idx, _ = _inputs(rows=64, dim=128, batch=16, nnz=4)
    want = embedding_bag_pallas(jnp.asarray(table).astype(dtype),
                                jnp.asarray(idx))
    want = np.asarray(want.astype(jnp.float32))
    got = emb_gather(torch.from_numpy(table).to(getattr(torch, dtype)),
                     torch.from_numpy(idx)).float().numpy()
    rtol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)


def test_autograd_matches_embedding_bag_grad():
    table, idx, _ = _inputs()
    g = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)
    want = np.asarray(jax_embedding_bag_grad(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(g)))
    tt = torch.from_numpy(table).requires_grad_(True)
    out = embedding_bag(tt, torch.from_numpy(idx))
    (out * torch.from_numpy(g)).sum().backward()
    # duplicate ids are summed in another order: rtol 1e-4
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=1e-4, atol=1e-6)
    direct = embedding_bag_grad(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(g))
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-4, atol=1e-6)


def test_weighted_grads_match_jax():
    table, idx, w = _inputs(rows=40, batch=16)
    g = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)

    def jloss(t, ww):
        return jnp.sum(jax_embedding_bag(t, jnp.asarray(idx), ww) * g)

    jt, jw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (embedding_bag(tt, torch.from_numpy(idx), tw)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jt), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-5)


def test_pad_row_bags():
    indices = np.array([5, 1, 2, 7, 3, 3], dtype=np.int64)
    offsets = np.array([0, 1, 3, 4], dtype=np.int64)  # [5] [1,2] [7] [3,3]
    dense, mx = pad_ragged_indices(indices, offsets, num_rows=10)
    ref_dense, ref_mx = jax_pad_ragged_indices(indices, offsets, num_rows=10)
    assert mx == ref_mx == 2
    np.testing.assert_array_equal(dense, ref_dense)
    table = torch.from_numpy(
        np.random.default_rng(0).random((10, 4)).astype(np.float32))
    padded = with_pad_row(table)
    assert padded.shape == (11, 4) and not padded[10].any()
    out = embedding_bag(padded, torch.from_numpy(dense))
    torch.testing.assert_close(out[0], table[5])  # pad row adds nothing
    torch.testing.assert_close(out[1], table[1] + table[2])
    torch.testing.assert_close(out[3], 2 * table[3])


def test_out_of_range_ids_match_jax_take():
    """Ids in [-R, 0) count from the end; ids >= R or < -R make the bag NaN
    (jnp.take's fill mode); the table gradient ignores them."""
    table, idx, w = _inputs(rows=40, batch=8)
    idx[1, 0], idx[2, 3], idx[3, 1], idx[4, 2] = -1, -40, 40, -41
    want = np.asarray(jax_embedding_bag(jnp.asarray(table), jnp.asarray(idx)))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert np.isnan(want[3]).all() and np.isnan(want[4]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)
    g = np.random.default_rng(3).standard_normal((8, 16)).astype(np.float32)
    want_g = np.asarray(jax_embedding_bag_grad(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(g)))
    got_g = embedding_bag_grad(torch.from_numpy(table), torch.from_numpy(idx),
                               torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-6)


def test_bytes_formula():
    assert embedding_bytes(2048, 30, 128, 4) == 2048 * 30 * 128 * 4


def test_cuda_wrapper_rejects_cpu_dispatch_and_bad_inputs():
    table, idx, _ = _inputs()
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    # a CPU tensor goes to the plain version
    torch.testing.assert_close(emb_gather(t, i), emb_gather_plain(t, i))
    with pytest.raises(TypeError):
        emb_gather_cuda(t, i.long())
    with pytest.raises(TypeError):
        emb_gather_cuda(t.double(), i)
    with pytest.raises(ValueError):
        emb_gather_cuda(t.t(), i)

