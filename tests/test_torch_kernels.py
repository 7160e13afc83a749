"""K1 and K2 against numpy loops (plain versions, on the CPU) and against
their plain versions (CUDA kernels, on the card).

This file imports neither JAX nor the reference package, so it also runs on
a machine with a GPU and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

The ``cuda`` tests skip without a GPU.  Tolerances: f32 rtol=1e-5,
atol=1e-5 (sums of up to 7 terms of magnitude ~1 taken in another order;
the kernel may fuse multiply-adds); bf16 rtol=8e-3 (one bf16 ulp of the
rounded sum).
"""

import numpy as np
import pytest
import torch

from param_tpu_torch import kernels
from param_tpu_torch.kernels.emb_gather import emb_gather_cuda, emb_gather_plain
from param_tpu_torch.kernels.sparse_update import (
    sparse_update_cuda, sparse_update_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bags(rows, dim, batch, nnz, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    idx = rng.integers(0, rows, size=(batch, nnz)).astype(np.int32)
    w = rng.random((batch, nnz)).astype(np.float32)
    return table, idx, w


def _updates(R, D, n_valid, n_drop, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, D)).astype(np.float32)
    acc = rng.random((R, D)).astype(np.float32) * 0.2
    acc[:, 0] = 0.0  # exercise the zero-accumulator gate
    ids = rng.permutation(R)[:n_valid]
    idx = np.concatenate([ids, R + rng.integers(0, 5, n_drop)]).astype(np.int32)
    idx = idx[rng.permutation(len(idx))]
    upd = rng.standard_normal((len(idx), D)).astype(np.float32)
    upd[:, 0] = 0.0
    return table, acc, idx, upd


def test_emb_gather_plain_matches_loop():
    table, idx, w = _bags(50, 6, 9, 5)
    idx[0, 0], idx[1, 1] = -3, 50  # counts from the end; out of range
    got = emb_gather_plain(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(w)).numpy()
    want = np.zeros((9, 6), np.float32)
    for b in range(9):
        for j in range(5):
            r = idx[b, j]
            want[b] += w[b, j] * (table[r] if -50 <= r < 50 else np.nan)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isnan(got[1]).all()


@pytest.mark.parametrize("mode", ["sgd", "adagrad"])
def test_sparse_update_plain_matches_loop(mode):
    table, acc, idx, upd = _updates(40, 5, 20, 4)
    lr, eps = 0.1, 1e-7
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    sparse_update_plain(t, torch.from_numpy(idx), torch.from_numpy(upd),
                        a if mode == "adagrad" else None, lr=lr, eps=eps)
    wt, wa = table.copy(), acc.copy()
    for i, r in enumerate(idx):
        if r >= 40:
            continue
        if mode == "sgd":
            wt[r] += upd[i]
        else:
            wa[r] += upd[i] ** 2
            f = np.where(wa[r] > 0, 1 / np.sqrt(wa[r] + eps), 0)
            wt[r] += -lr * upd[i] * f
    np.testing.assert_allclose(t.numpy(), wt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), wa, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dim", [(torch.float32, 64), (torch.float32, 128),
                                       (torch.float32, 18), (torch.float32, 200),
                                       (torch.bfloat16, 64),
                                       (torch.bfloat16, 20)])
def test_emb_gather_kernel_matches_plain(cuda_device, dtype, dim):
    table, idx, w = _bags(4096, dim, 300, 7)
    idx[5, 2], idx[6, 0], idx[7, 6] = -1, 4096, -4097  # wraps, NaN, NaN
    t = torch.from_numpy(table).to(cuda_device, dtype)
    i = torch.from_numpy(idx).to(cuda_device)
    before = kernels.launch_counts["emb_gather"]
    for weights in (None, torch.from_numpy(w).to(cuda_device)):
        got = emb_gather_cuda(t, i, weights).float()
        want = emb_gather_plain(t, i, weights).float()
        rtol = 1e-5 if dtype == torch.float32 else 8e-3
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5,
                                   equal_nan=True)
        assert got[6:8].isnan().all() and not got[5].isnan().any()
    assert kernels.launch_counts["emb_gather"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 128, 13])
@pytest.mark.parametrize("mode", ["sgd", "adagrad"])
def test_sparse_update_kernel_matches_plain(cuda_device, mode, dim):
    table, acc, idx, upd = _updates(5000, dim, 3000, 100)
    dev = cuda_device
    t0, a0 = torch.from_numpy(table).to(dev), torch.from_numpy(acc).to(dev)
    i, u = torch.from_numpy(idx).to(dev), torch.from_numpy(upd).to(dev)
    t1, a1 = t0.clone(), a0.clone()
    use_acc = mode == "adagrad"
    sparse_update_cuda(t0, i, u, a0 if use_acc else None, lr=0.05, eps=1e-7)
    sparse_update_plain(t1, i, u, a1 if use_acc else None, lr=0.05, eps=1e-7)
    torch.cuda.synchronize()
    torch.testing.assert_close(t0, t1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a0, a1, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_kernels_on_empty_inputs(cuda_device):
    t = torch.zeros((10, 8), device=cuda_device)
    out = emb_gather_cuda(t, torch.zeros((0, 3), dtype=torch.int32,
                                         device=cuda_device))
    assert out.shape == (0, 8)
    sparse_update_cuda(t, torch.zeros((0,), dtype=torch.int32,
                                      device=cuda_device),
                       torch.zeros((0, 8), device=cuda_device))
    torch.cuda.synchronize()
    assert not t.any()
