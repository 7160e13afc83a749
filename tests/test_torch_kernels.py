"""K1-K5 against numpy (plain versions, on the CPU) and against their plain
versions (CUDA kernels, on the card).

This file imports neither JAX nor the reference package, so it also runs on
a machine with a GPU and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

The ``cuda`` tests skip without a GPU.  Tolerances: f32 rtol=1e-5,
atol=1e-5 (sums of up to 7 terms of magnitude ~1 taken in another order;
the kernel may fuse multiply-adds); bf16 rtol=8e-3 (one bf16 ulp of the
rounded sum).  GEMMs (K3-K5) are held to a bound on the largest error over
the whole output: f32 1e-5 x max|out| (sums of up to a few hundred terms in
another order), bf16 / f16 outputs one ulp of max|out| (one rounding of an
f32 sum on each side).
"""

import math

import numpy as np
import pytest
import torch

from param_tpu_torch import kernels
from param_tpu_torch.kernels.emb_gather import emb_gather_cuda, emb_gather_plain
from param_tpu_torch.kernels.gemm import (
    gemm_cuda, gemm_plain, gemm_wres_cuda, gemm_wres_plain,
)
from param_tpu_torch.kernels.int4_gemm import (
    int4_dequant, int4_gemm_cuda, int4_gemm_plain, mma_schedule,
)
from param_tpu_torch.kernels.sparse_update import (
    sparse_update_cuda, sparse_update_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
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


def _max_err_tol(got, want):
    """(largest error, tolerance) of a GEMM output against its plain
    version, both in the output dtype."""
    ref = want.float().abs().max().item()
    if want.dtype == torch.float32:
        tol = 1e-5 * ref + 1e-30
    else:  # one ulp of max|out| in the output dtype
        mant = 7 if want.dtype == torch.bfloat16 else 10
        tol = 2.0 ** (math.floor(math.log2(max(ref, 1e-30))) - mant)
    return (got.float() - want.float()).abs().max().item(), tol


def _packed(kh, n, groups, seed=0):
    rng = np.random.default_rng(seed)
    packed = rng.integers(-128, 128, size=(kh, n)).astype(np.int8)
    scale = (rng.random((groups, n)) * 0.1 + 0.01).astype(np.float32)
    return packed, scale


def test_int4_dequant_matches_loop():
    packed, scale = _packed(6, 5, 3)
    got = int4_dequant(torch.from_numpy(packed), torch.from_numpy(scale))
    want = np.zeros((12, 5), np.float32)
    for i in range(6):
        for j in range(5):
            b = int(packed[i, j])
            want[2 * i, j] = ((b & 15) - 8) * scale[i // 2, j]
            want[2 * i + 1, j] = (b >> 4) * scale[i // 2, j]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,kh", [(1, 4096, 2048), (8, 11008, 2048),
                                    (32, 4096, 5504), (512, 4096, 2048),
                                    (5, 200, 256), (3, 64, 8)])
def test_mma_schedule_covers_k_in_k16_steps(m, n, kh):
    rows, splits = mma_schedule(m, n, kh, sms=132)
    assert rows % 8 == 0 and splits * rows >= kh
    assert (splits - 1) * rows < kh  # no split without work


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,n,k", [(100, 100, 100), (256, 256, 256),
                                   (128, 1024, 64), (1, 8, 8), (300, 136, 520),
                                   (129, 257, 33)])
def test_gemm_kernel_matches_plain(cuda_device, dtype, m, n, k):
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    key = {torch.float32: "gemm_f32", torch.bfloat16: "gemm_bf16",
           torch.float16: "gemm_f16"}[dtype]
    before = kernels.launch_counts[key]
    for out_dtype in (None, torch.float32):
        got = gemm_cuda(a, b, out_dtype)
        want = gemm_plain(a, b, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == (m, n)
        err, tol = _max_err_tol(got, want)
        assert err <= tol, (err, tol)
    assert kernels.launch_counts[key] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,m,k,n", [(4, 64, 128, 256), (3, 50, 72, 100)])
def test_gemm_wres_kernel_matches_plain(cuda_device, dtype, s, m, k, n):
    rng = np.random.default_rng(s * m)
    a = torch.from_numpy(rng.standard_normal((s, m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    before = kernels.launch_counts["gemm_wres"]
    got = gemm_wres_cuda(a, b)
    want = gemm_wres_plain(a, b)
    torch.cuda.synchronize()
    assert got.shape == (s, m, n)
    err, tol = _max_err_tol(got, want)
    assert err <= tol, (err, tol)
    assert kernels.launch_counts["gemm_wres"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 32, 33, 96])
@pytest.mark.parametrize("n,kh,groups", [(256, 256, 4), (200, 256, 2),
                                         (200, 250, 2), (1024, 512, 8),
                                         (136, 96, 3)])
def test_int4_gemm_kernel_matches_plain(cuda_device, m, n, kh, groups):
    packed, scale = _packed(kh, n, groups, seed=m)
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, 2 * kh), dtype=np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    p = torch.from_numpy(packed).to(cuda_device)
    sc = torch.from_numpy(scale).to(cuda_device)
    before = kernels.launch_counts["int4_gemm"]
    for out_dtype in (torch.float32, torch.bfloat16):
        got = int4_gemm_cuda(x, p, sc, out_dtype)
        want = int4_gemm_plain(x, p, sc, out_dtype)
        torch.cuda.synchronize()
        err, tol = _max_err_tol(got, want)
        assert err <= tol, (err, tol)
    assert kernels.launch_counts["int4_gemm"] == before + 2


@pytest.mark.cuda
def test_gemm_kernels_raise_on_what_they_do_not_take(cuda_device):
    a = torch.ones((4, 8), device=cuda_device)
    with pytest.raises(TypeError):
        gemm_cuda(a, a.T.contiguous().to(torch.bfloat16))
    with pytest.raises(ValueError):
        gemm_cuda(a, a)
    with pytest.raises(TypeError):
        int4_gemm_cuda(a, torch.zeros((4, 8), dtype=torch.int8,
                                      device=cuda_device),
                       torch.ones((1, 8), device=cuda_device))
