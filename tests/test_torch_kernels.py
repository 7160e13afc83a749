"""K1-K8 against numpy (plain versions, on the CPU) and against their plain
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
f32 sum on each side).  K6 (flash attention) on unit-scale inputs: f32
2e-5 absolute (the reference's flash tolerance); bf16 / f16 every element
within its own bound, ``flash_fwd_tolerance`` (one rounding of O on each
side and P rounded to the input dtype before the PV product), and 2e-2
absolute over the whole output; lse 1e-4 absolute.  K7 (flash-attention
backward) every element of dq, dk and dv within its own bound,
``flash_bwd_tolerance`` (f32: 2^-14 of the element's magnitude terms; bf16
/ f16: one rounding of each output per side, and P and dS rounded to the
input dtype before their products); the plain version against autograd of
K6's plain version 2e-5 (f32 sums in another order).  K8a-d (ring
collectives over per-rank shards on one card): bitwise equal to their plain
versions, which walk the same ring (copies, and one add in the input dtype
per hop in the same order).  K9 (k-row fetch, tile sums) rtol 1e-4 and
K10 (block-coalesced bag) rtol 1e-5, the coalesced-fetch script's own
(sums of up to 4096 rows, and bags summed in another order).  Decode
attention on the card (bf16 cache contracted with f32 accumulation)
against the reference's output on stored inputs and against the f32
product of the upcast operands: atol 1e-4, rtol 1e-3 (one bf16 rounding of
P may flip where a logit sums in another order).
"""

import math

import numpy as np
import pytest
import torch

from param_tpu_torch import kernels
from param_tpu_torch.kernels.coalesce import (
    coalesce_plan, coalesced_bag_cuda, desc_fetch_cuda, desc_fetch_plain,
)
from param_tpu_torch.kernels.emb_gather import emb_gather_cuda, emb_gather_plain
from param_tpu_torch.kernels.flash_bwd import (
    flash_bwd_cuda, flash_bwd_plain, flash_bwd_tolerance, kernel_layout,
)
from param_tpu_torch.kernels.flash_fwd import (
    attention_keep_mask, flash_fwd_cuda, flash_fwd_plain, flash_fwd_tolerance,
)
from param_tpu_torch.kernels.gemm import (
    gemm_cuda, gemm_plain, gemm_schedule, gemm_wres_cuda, gemm_wres_plain,
    k_split,
)
from param_tpu_torch.kernels.int4_gemm import (
    int4_dequant, int4_gemm_cuda, int4_gemm_plain, mma_schedule,
)
from param_tpu_torch.kernels.ring import (
    check_errors, ring_all_gather_bidir_cuda, ring_all_gather_bidir_plain,
    ring_all_gather_cuda, ring_all_gather_plain, ring_loopback_cuda,
    ring_loopback_plain, ring_reduce_scatter_cuda, ring_reduce_scatter_plain,
)
from param_tpu_torch.kernels.sparse_update import (
    sparse_update_cuda, sparse_update_plain,
)
from param_tpu_torch.ops.datasets import GEMM_A, GEMM_B, GEMM_C


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


_GEMM_ODD = [(100, 100, 100), (256, 256, 256), (128, 1024, 64), (1, 8, 8),
             (300, 136, 520), (129, 257, 33)]
_GEMM_SHAPES = sorted(set(GEMM_A + GEMM_B + GEMM_C + _GEMM_ODD))
_SMS = 132  # an H100's SMs


def _tiles_steps(m, n, k, tile):
    bm, bn, bk = tile
    return math.ceil(m / bm) * math.ceil(n / bn), math.ceil(k / bk)


@pytest.mark.parametrize("m,n,k", _GEMM_SHAPES)
def test_gemm_schedule_splits_k_without_empty_splits(m, n, k):
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for aligned in (True, False):
            path, tile, splits = gemm_schedule(m, n, k, dtype, aligned, _SMS)
            _, steps = _tiles_steps(m, n, k, tile)
            per = k_split(k, tile[2], splits)
            assert splits >= 1 and per % tile[2] == 0
            assert splits * per >= k  # every K step has a split ...
            assert (splits - 1) * per < k  # ... and every split a K step
            if path == "mma_sync":
                assert splits == 1


@pytest.mark.parametrize("m,n,k", _GEMM_SHAPES)
def test_gemm_schedule_takes_wgmma_exactly_for_aligned_16_bit(m, n, k):
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for aligned in (True, False):
            path = gemm_schedule(m, n, k, dtype, aligned, _SMS)[0]
            want = ("simt" if dtype == torch.float32
                    else "wgmma" if aligned else "mma_sync")
            assert path == want, (dtype, aligned, path)


@pytest.mark.parametrize("m,n,k", GEMM_A)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemm_schedule_fills_the_card_at_gemm_a(m, n, k, dtype):
    """One split when the tiles alone fill a wave (one block an SM);
    otherwise the splits fit in that wave and leave a block the fewest K
    steps that any split count fitting in it could."""
    path, tile, splits = gemm_schedule(m, n, k, dtype, True, _SMS)
    tiles, steps = _tiles_steps(m, n, k, tile)
    wave = _SMS
    if tiles >= wave:
        assert splits == 1
        return
    assert tiles * splits <= wave
    fewest = min(math.ceil(steps / s) for s in range(1, wave // tiles + 1))
    assert math.ceil(steps / splits) == fewest, (tiles, splits, fewest)


def test_gemm_schedule_at_the_redesign_shapes():
    assert gemm_schedule(1024, 4096, 4096, torch.bfloat16, True, _SMS) == (
        "wgmma", (128, 256, 64), 1)  # 128 tiles, one wave
    assert gemm_schedule(1024, 1024, 4096, torch.float32, True, _SMS) == (
        "simt", (128, 128, 16), 2)  # GEMM_C: 64 tiles x 2 splits
    assert gemm_schedule(128, 1024, 1024, torch.bfloat16, True, _SMS)[2] \
        == 16  # 4 tiles: one K step a split
    assert gemm_schedule(1024, 1024, 128, torch.bfloat16, True, _SMS)[2] \
        == 2
    assert gemm_schedule(1024, 1024, 128, torch.bfloat16, False, _SMS) == (
        "mma_sync", (128, 128, 32), 1)


def _gemm_path(dtype, n, k):
    """The launch counter of the 16-bit path taken (None for f32)."""
    if dtype == torch.float32:
        return None
    return "gemm_wgmma" if n % 8 == 0 and k % 8 == 0 else "gemm_mma_sync"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,n,k", _GEMM_ODD + [
    (128, 1024, 1024), (1024, 1024, 128), (136, 264, 520)])
def test_gemm_kernel_matches_plain(cuda_device, dtype, m, n, k):
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    key = {torch.float32: "gemm_f32", torch.bfloat16: "gemm_bf16",
           torch.float16: "gemm_f16"}[dtype]
    path = _gemm_path(dtype, n, k)
    before = dict(kernels.launch_counts)
    for out_dtype in (None, torch.float32):
        got = gemm_cuda(a, b, out_dtype)
        want = gemm_plain(a, b, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == (m, n)
        err, tol = _max_err_tol(got, want)
        assert err <= tol, (err, tol)
    moved = {c for c, v in kernels.launch_counts.items() if v != before[c]}
    assert kernels.launch_counts[key] == before[key] + 2
    assert moved == {key} | ({path} if path else set()), moved
    if path:
        assert kernels.launch_counts[path] == before[path] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_split_k_is_the_same_from_run_to_run(cuda_device, dtype):
    """The splits are added in a fixed order: bitwise-equal results."""
    m, n, k = 128, 1024, 1024
    assert gemm_schedule(m, n, k, dtype, True, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)[2] > 1
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    first = gemm_cuda(a, b, torch.float32)
    second = gemm_cuda(a, b, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    err, tol = _max_err_tol(first, gemm_plain(a, b, torch.float32))
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,m,k,n", [(4, 64, 128, 256), (3, 50, 72, 100),
                                     (2, 128, 1024, 512)])
def test_gemm_wres_kernel_matches_plain(cuda_device, dtype, s, m, k, n):
    rng = np.random.default_rng(s * m)
    a = torch.from_numpy(rng.standard_normal((s, m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    path = _gemm_path(dtype, n, k)
    before = dict(kernels.launch_counts)
    got = gemm_wres_cuda(a, b)
    want = gemm_wres_plain(a, b)
    torch.cuda.synchronize()
    assert got.shape == (s, m, n)
    err, tol = _max_err_tol(got, want)
    assert err <= tol, (err, tol)
    assert kernels.launch_counts["gemm_wres"] == before["gemm_wres"] + 1
    if path:
        assert kernels.launch_counts[path] == before[path] + 1


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


def _attn(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("causal,window,hkv,sq", [
    (False, None, 4, 7), (True, None, 4, 7), (True, None, 2, 3),
    (True, 3, 1, 7), (True, 2, 4, 5)])
def test_flash_fwd_plain_matches_loop(causal, window, hkv, sq):
    b, h, sk, d = 2, 4, 7, 8
    q, k, v = _attn(b, h, hkv, sq, sk, d, seed=sq)
    out, lse = flash_fwd_plain(q, k, v, causal, 0.3, window, return_lse=True)
    qn, kn, vn = q.numpy(), k.numpy(), v.numpy()
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // hkv)
            for r in range(sq):
                cols = [c for c in range(sk) if not causal or (
                    c <= r + sk - sq and (window is None
                                          or c > r + sk - sq - window))]
                s = np.array([qn[bi, hi, r] @ kn[bi, kv, c] for c in cols])
                s = s * 0.3
                p = np.exp(s - s.max())
                want = (p[:, None] * vn[bi, kv, cols]).sum(0) / p.sum()
                np.testing.assert_allclose(out[bi, hi, r].numpy(), want,
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(
                    lse[bi, hi, r].item(), s.max() + np.log(p.sum()),
                    rtol=1e-5, atol=1e-6)


def test_flash_fwd_plain_raises_like_the_kernel():
    q, k, v = _attn(1, 4, 3, 8, 8, 8)
    with pytest.raises(ValueError, match="inconsistent"):
        flash_fwd_plain(q, k, v)
    q, k, v = _attn(1, 2, 2, 9, 8, 8)
    with pytest.raises(NotImplementedError, match="S_q <= S_k"):
        flash_fwd_plain(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="causal"):
        flash_fwd_plain(q, k, v, window=4)


def _k6_roundings(q, k, v, causal, window):
    """K6's roundings on the CPU: f32 scores, P rounded to the input dtype
    before the PV product, f32 sums and normaliser, O rounded once."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = q.float() @ kf.transpose(-1, -2) / math.sqrt(q.shape[-1])
    keep = attention_keep_mask(q.shape[2], k.shape[2], causal, window, "cpu")
    if keep is not None:
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(q.dtype).float() @ vf) / p.sum(-1, keepdim=True)
    return o.to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", [
    (1, 4, 4, 256, 256, 128, True, None), (2, 3, 3, 192, 192, 64, False, None),
    (1, 4, 1, 256, 256, 128, True, None), (1, 2, 2, 100, 1000, 64, True, 300)])
def test_flash_fwd_tolerance_holds_k6_roundings(dtype, b, h, hkv, sq, sk, d,
                                                causal, window):
    """The per-element bound admits an output rounded as K6 rounds it."""
    q, k, v = (t.to(dtype) for t in _attn(b, h, hkv, sq, sk, d, seed=sq + d))
    want = flash_fwd_plain(q, k, v, causal, None, window)
    tol = flash_fwd_tolerance(q, k, v, want, causal, None, window)
    diff = (_k6_roundings(q, k, v, causal, window).float()
            - want.float()).abs()
    assert diff.max().item() > 0 and (diff <= tol).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_fwd_tolerance_flags_a_dropped_kv_entry(dtype):
    """Each row's diagonal kv entry dropped (row r attends 0..r-1): the
    bound flags it on the late rows, where one entry of ~S moves O least."""
    q, k, v = (t.to(dtype) for t in _attn(1, 4, 4, 256, 256, 64, seed=3))
    want = flash_fwd_plain(q, k, v, True)
    tol = flash_fwd_tolerance(q, k, v, want, True)
    bad = flash_fwd_plain(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1], True)
    late = slice(127, None)  # rows 128..255 of the whole output
    diff = (bad[:, :, late].float() - want[:, :, 1:][:, :, late].float()).abs()
    assert (diff > tol[:, :, 1:][:, :, late]).any()


# (B, H, H_kv, S_q, S_k, D, causal, window): the chip_smoke phase-11 cases
# scaled down, plus the head dim 32 and ragged lengths
_K6_CASES = [
    (1, 4, 4, 256, 256, 128, True, None),
    (2, 3, 3, 192, 192, 64, False, None),
    (1, 4, 1, 256, 256, 128, True, None),
    (1, 4, 2, 256, 256, 128, False, None),
    (1, 2, 2, 512, 512, 128, True, 96),
    (1, 2, 2, 384, 384, 64, True, 64),
    (1, 2, 2, 64, 320, 128, True, None),
    (1, 2, 2, 100, 1000, 64, True, 300),
    (2, 2, 2, 100, 100, 32, True, None),
    (1, 3, 3, 250, 250, 128, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", _K6_CASES)
def test_flash_fwd_kernel_matches_plain(cuda_device, dtype, b, h, hkv, sq, sk,
                                        d, causal, window):
    q, k, v = (t.to(cuda_device, dtype) for t in _attn(b, h, hkv, sq, sk, d,
                                                        seed=sq + d))
    before = kernels.launch_counts["flash_fwd"]
    got, lse = flash_fwd_cuda(q, k, v, causal, None, window, return_lse=True)
    want, want_lse = flash_fwd_plain(q, k, v, causal, None, window,
                                     return_lse=True)
    assert flash_fwd_cuda(q, k, v, causal, None, window).shape == got.shape
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_fwd"] == before + 2
    assert got.dtype == dtype and got.shape == (b, h, sq, d)
    tol = flash_fwd_tolerance(q, k, v, want, causal, None, window)
    diff = (got.float() - want.float()).abs()
    assert (diff <= tol).all(), (diff / tol).max().item()
    assert diff.max().item() <= (2e-5 if dtype == torch.float32 else 2e-2)
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_fwd_kernel_takes_strided_heads(cuda_device):
    """Heads split out of a fused (B, S, 3 H D) projection, as the
    transformer block passes them, with no copy."""
    b, s, h, d = 2, 130, 4, 64
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d),
                                               dtype=np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    got = flash_fwd_cuda(q, k, v, causal=True)
    want = flash_fwd_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    assert (diff <= flash_fwd_tolerance(q, k, v, want, True)).all()
    assert diff.max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_fwd_kernel_raises_on_what_it_does_not_take(cuda_device):
    q = torch.ones((1, 2, 16, 96), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd_cuda(q, q, q)
    q = torch.ones((1, 2, 64, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_fwd_cuda(q, q.float(), q)
    with pytest.raises(NotImplementedError):
        flash_fwd_cuda(q, q, q, window=4)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_cuda(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))


@pytest.mark.cuda
def test_block_apply_runs_k6_where_the_reference_falls_back(cuda_device):
    """S = 1536 is no multiple of the reference's 1024 block, so its
    flash_mha takes the unfused path; on the card the port runs K6 (it masks
    ragged ends itself) and agrees with the CPU's unfused path."""
    from param_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(batch=1, seq=1536, emb=256, heads=4, ffn=512,
                                dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    x_cpu = torch.randn((1, 1536, 256),
                        generator=torch.Generator().manual_seed(1)) * 0.1
    p_gpu = {key: (tuple(t.to(cuda_device) for t in val)
                   if isinstance(val, tuple) else val.to(cuda_device))
             for key, val in p_cpu.items()}
    before = kernels.launch_counts["flash_fwd"]
    with torch.no_grad():
        got = tfm.block_apply(p_gpu, x_cpu.to(cuda_device), cfg)
        want = tfm.block_apply(p_cpu, x_cpu, cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_fwd"] == before + 1
    ref = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * ref


# ------------------------------------------------------------------ K7
def _bwd_inputs(b, h, hkv, sq, sk, d, causal, dtype=torch.float32, seed=0,
                device="cpu"):
    """q, k, v, o, lse, do: o and lse from K6's plain version (K6 itself on
    the card), do from the seeded generator."""
    q, k, v = (t.to(device, dtype) for t in _attn(b, h, hkv, sq, sk, d,
                                                   seed=seed))
    fwd = flash_fwd_cuda if q.device.type == "cuda" else flash_fwd_plain
    o, lse = fwd(q, k, v, causal, None, None, return_lse=True)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d),
                                              dtype=np.float32))
    return q, k, v, o, lse, do.to(device, dtype)


_K7_CPU_CASES = [(2, 4, 4, 7, 7, 8, True), (2, 4, 2, 5, 9, 8, True),
                 (1, 4, 1, 6, 6, 8, False), (1, 2, 2, 3, 11, 16, True),
                 (2, 6, 3, 9, 9, 4, False)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", _K7_CPU_CASES)
def test_flash_bwd_plain_matches_autograd(b, h, hkv, sq, sk, d, causal):
    """The plain backward from (o, lse) equals autograd straight through
    K6's plain version (GQA: autograd sums the repeated kv heads)."""
    q, k, v, _, _, do = _bwd_inputs(b, h, hkv, sq, sk, d, causal, seed=sq)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_fwd_plain(*leaves, causal, None, None, return_lse=True)
    want = torch.autograd.grad(o, leaves, do)
    got = flash_bwd_plain(q, k, v, o.detach(), lse.detach(), do, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_flash_bwd_plain_raises_on_bad_shapes():
    q, k, v, o, lse, do = _bwd_inputs(1, 2, 2, 8, 8, 8, False)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_plain(q, k, v, o, lse[:, :, :4], do)
    with pytest.raises(ValueError, match="shape"):
        flash_bwd_plain(q, k, v, o[:, :1], lse, do)
    with pytest.raises(NotImplementedError, match="S_q <= S_k"):
        flash_bwd_plain(q, k[:, :, :4], v[:, :, :4], o, lse, do, True)


def test_kernel_layout_copies_only_what_the_kernel_cannot_read():
    x = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    heads = x.transpose(1, 2)  # (2, 4, 8, 64): strided, last dim contiguous
    assert kernel_layout(heads) is heads
    summed = torch.ones((), dtype=torch.bfloat16).expand(2, 4, 8, 64)
    assert summed.stride(-1) == 0
    out = kernel_layout(summed)
    assert out.is_contiguous() and torch.equal(out, summed)


def _k7_roundings(q, k, v, o, lse, do, causal):
    """K7's roundings on the CPU: f32 P, dP and D; P rounded to the input
    dtype before P^T dO, dS before dS K and dS^T Q; outputs rounded once."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = q.float() @ kf.transpose(-1, -2) * scale
    p = torch.exp(s - lse[..., None])
    keep = attention_keep_mask(q.shape[2], k.shape[2], causal, None, "cpu")
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = do.float() @ vf.transpose(-1, -2)
    ds = p * (dp - (do.float() * o.float()).sum(-1, keepdim=True)) * scale
    pr, dsr = p.to(q.dtype).float(), ds.to(q.dtype).float()
    b, h, sq, d = q.shape

    def gsum(t):
        return t.reshape(b, k.shape[1], group, k.shape[2], d).sum(2)

    return ((dsr @ kf).to(q.dtype),
            gsum(dsr.transpose(-1, -2) @ q.float()).to(k.dtype),
            gsum(pr.transpose(-1, -2) @ do.float()).to(v.dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 4, 4, 256, 256, 128, True), (2, 3, 3, 192, 192, 64, False),
    (1, 4, 2, 100, 300, 32, True)])
def test_flash_bwd_tolerance_holds_k7_roundings(dtype, b, h, hkv, sq, sk, d,
                                                causal):
    """The per-element bounds admit outputs rounded as K7 rounds them."""
    ins = _bwd_inputs(b, h, hkv, sq, sk, d, causal, dtype, seed=sq + d)
    want = flash_bwd_plain(*ins, causal)
    tols = flash_bwd_tolerance(*ins, want, causal)
    for got, w, tol in zip(_k7_roundings(*ins, causal), want, tols):
        diff = (got.float() - w.float()).abs()
        assert diff.max().item() > 0 and (diff <= tol).all(), \
            (diff / tol).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_flash_bwd_tolerance_flags_a_dropped_kv_entry(dtype):
    """Each row's diagonal kv entry dropped (row r attends 0..r-1, the true
    lse kept): dq, dk and dv each have elements over their bounds."""
    q, k, v, o, lse, do = _bwd_inputs(1, 4, 4, 256, 256, 64, True, dtype,
                                      seed=3)
    want = flash_bwd_plain(q, k, v, o, lse, do, True)
    tols = flash_bwd_tolerance(q, k, v, o, lse, do, want, True)
    bad = flash_bwd_plain(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1],
                          o[:, :, 1:], lse[:, :, 1:], do[:, :, 1:], True)
    for i, cut in enumerate((slice(1, None), slice(None, -1),
                             slice(None, -1))):
        diff = (bad[i].float() - want[i][:, :, cut].float()).abs()
        assert (diff > tols[i][:, :, cut]).any(), "qkv"[i]


# (B, H, H_kv, S_q, S_k, D, causal): the chip_smoke phase-14 cases cut
# down, at head dims 32, 64 and 128, with ragged and rectangular lengths
_K7_CASES = [
    (1, 4, 4, 256, 256, 128, True),
    (2, 3, 3, 192, 192, 64, False),
    (1, 4, 1, 256, 256, 128, True),
    (1, 4, 2, 200, 200, 64, True),
    (1, 2, 2, 64, 320, 128, True),
    (1, 3, 3, 250, 250, 128, True),
    (2, 2, 2, 100, 100, 32, True),
    (1, 4, 2, 100, 300, 32, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", _K7_CASES)
def test_flash_bwd_kernel_matches_plain(cuda_device, dtype, b, h, hkv, sq, sk,
                                        d, causal):
    ins = _bwd_inputs(b, h, hkv, sq, sk, d, causal, dtype, seed=sq + d,
                      device=cuda_device)
    before = kernels.launch_counts["flash_bwd"]
    got = flash_bwd_cuda(*ins, causal)
    want = flash_bwd_plain(*ins, causal)
    tols = flash_bwd_tolerance(*ins, want, causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_bwd"] == before + 1
    for g, w, tol in zip(got, want, tols):
        assert g.dtype == dtype and g.shape == w.shape and g.is_contiguous()
        diff = (g.float() - w.float()).abs()
        assert (diff <= tol).all(), (diff / tol).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_kernel_takes_strided_heads(cuda_device, d):
    """q, k, v split out of a fused (B, S, 3 H D) projection and dO the
    transposed-head gradient of (B, S, H D), as the block passes them."""
    b, s, h = 2, 130, 4
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d),
                                               dtype=np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(h * d, dim=-1))
    g = torch.from_numpy(rng.standard_normal((b, s, h * d), dtype=np.float32))
    do = g.to(cuda_device, torch.bfloat16).reshape(b, s, h, d).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = flash_fwd_cuda(q, k, v, True, return_lse=True)
    got = flash_bwd_cuda(q, k, v, o, lse, do, True)
    dense = [t.contiguous() for t in (q, k, v, o)] + [lse, do.contiguous()]
    want = flash_bwd_plain(*dense, True)
    tols = flash_bwd_tolerance(*dense, want, True)
    torch.cuda.synchronize()
    for x, w, tol in zip(got, want, tols):
        assert ((x.float() - w.float()).abs() <= tol).all()


@pytest.mark.cuda
def test_flash_bwd_kernel_raises_on_what_it_does_not_take(cuda_device):
    ins = _bwd_inputs(1, 2, 2, 64, 64, 64, True, torch.bfloat16,
                      device=cuda_device)
    q, k, v, o, lse, do = ins
    with pytest.raises(TypeError, match="lse"):
        flash_bwd_cuda(q, k, v, o, lse.bfloat16(), do)
    with pytest.raises(TypeError):
        flash_bwd_cuda(q, k, v, o, lse, do.float())
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd_cuda(q, k, v, o, lse, do.transpose(2, 3))
    x = torch.ones((1, 2, 16, 96), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_bwd_cuda(x, x, x, x, torch.zeros((1, 2, 16),
                                               device=cuda_device), x)


@pytest.mark.cuda
def test_block_apply_backward_runs_k7(cuda_device):
    """At S = 1536 (the reference's CPU fallback shape) the block's
    gradients on the card come from K6 and K7, once each, and agree with
    the CPU's unfused path."""
    from param_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(batch=1, seq=1536, emb=256, heads=4, ffn=512,
                                dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    x_cpu = torch.randn((1, 1536, 256),
                        generator=torch.Generator().manual_seed(1)) * 0.1
    p_gpu = {key: (tuple(t.to(cuda_device) for t in val)
                   if isinstance(val, tuple) else val.to(cuda_device))
             for key, val in p_cpu.items()}
    kernels.reset_launch_counts()
    loss_g, grads_g = tfm.value_and_grad(p_gpu, x_cpu.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_fwd"] == 1
    assert kernels.launch_counts["flash_bwd"] == 1
    loss_c, grads_c = tfm.value_and_grad(p_cpu, x_cpu, cfg)
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * loss_c.item()
    for key in ("wqkv", "wo", "w1", "w2"):
        want = grads_c[key]
        err = (grads_g[key].cpu() - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), key


# ------------------------------------------------------------------ K8a-d
_RING_KERNELS = {
    "all_gather": (ring_all_gather_cuda, ring_all_gather_plain),
    "reduce_scatter": (ring_reduce_scatter_cuda, ring_reduce_scatter_plain),
    "bidir": (ring_all_gather_bidir_cuda, ring_all_gather_bidir_plain),
    "loopback": (ring_loopback_cuda, ring_loopback_plain),
}


def _ring_shards(n, shape, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).to(device)
            for _ in range(n)]


def _assert_ring_bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_ring_plain_versions_on_the_cpu():
    """The plain rings against the collectives they compute."""
    xs = _ring_shards(4, (8, 3), torch.float32, "cpu")
    stacked = torch.stack(xs)
    for fn in (ring_all_gather_plain, ring_all_gather_bidir_plain):
        for out in fn(xs):
            assert torch.equal(out, stacked)
    for r, out in enumerate(ring_all_gather_plain(xs, shift=1)):
        assert torch.equal(out, torch.roll(stacked, 1, 0))
    sums = ring_reduce_scatter_plain(xs)
    total = sum(x.reshape(4, 2, 3) for x in xs)
    for r, s in enumerate(sums):
        torch.testing.assert_close(s, total[(r + 1) % 4], rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(ring_loopback_plain(xs), xs):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_RING_KERNELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_kernel_matches_plain(cuda_device, kind, dtype, n):
    cuda_fn, plain_fn = _RING_KERNELS[kind]
    # 16-byte vector path and, with an odd bf16 / f16 count, the word path
    for shape in ((n * 4096,), (n * 8, 33), (n * 3 + 0,) if n > 1 else (5,)):
        xs = _ring_shards(n, shape, dtype, cuda_device, seed=n)
        _assert_ring_bitwise(cuda_fn(xs), plain_fn(xs))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_all_reduce_matches_plain_and_sum(cuda_device, n):
    from param_tpu_torch.ops.ring_collectives import ring_all_reduce

    xs = _ring_shards(n, (n * 1024, 4), torch.float32, cuda_device, seed=3)
    got = ring_all_reduce(xs)
    want = ring_all_reduce([x.cpu() for x in xs])
    _assert_ring_bitwise([g.cpu() for g in got], want)
    torch.testing.assert_close(got[0], sum(xs), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ring_kernels_repeat_and_replay_from_a_graph(cuda_device):
    """Each call bumps the flags' epoch on the card, so repeated calls and
    CUDA-graph replays of one launch never take an old flag for new."""
    xs = _ring_shards(4, (4096,), torch.float32, cuda_device)
    want = ring_reduce_scatter_plain(xs)
    for _ in range(3):
        _assert_ring_bitwise(ring_reduce_scatter_cuda(xs), want)
    ring_reduce_scatter_cuda(xs, check=False)  # warm up outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = ring_reduce_scatter_cuda(xs, check=False)
    for step in range(3):
        for x in xs:
            x.add_(1.0)
        graph.replay()
        check_errors(xs)
        _assert_ring_bitwise(outs, ring_reduce_scatter_plain(xs))


@pytest.mark.cuda
def test_ring_planted_fault_raises_and_the_next_call_is_clean(cuda_device):
    xs = _ring_shards(4, (1 << 18,), torch.float32, cuda_device)
    launches = kernels.launch_counts["ring_all_gather"]
    with pytest.raises(RuntimeError, match="bounded wait ran out"):
        ring_all_gather_cuda(xs, fault=1, timeout_s=0.05)
    assert kernels.launch_counts["ring_all_gather"] == launches + 1
    _assert_ring_bitwise(ring_all_gather_cuda(xs), ring_all_gather_plain(xs))


@pytest.mark.cuda
def test_ring_kernels_raise_on_what_they_do_not_take(cuda_device):
    xs = _ring_shards(2, (8,), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="same shape"):
        ring_all_gather_cuda([xs[0], xs[1][:4]])
    with pytest.raises(ValueError, match="divide"):
        ring_reduce_scatter_cuda(_ring_shards(3, (8,), torch.float32,
                                              cuda_device))
    with pytest.raises(TypeError, match="adds"):
        ring_reduce_scatter_cuda([x.int() for x in xs])
    with pytest.raises(ValueError, match="CUDA"):
        ring_all_gather_cuda([x.cpu() for x in xs])


@pytest.mark.cuda
def test_ring_across_cards_waits_for_a_busy_peer(cuda_device):
    """One rank per card: work still queued on a peer card holds every rank
    back, so no rank's bounded wait runs out while the peer is busy."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    xs = [torch.randn(1 << 16, generator=torch.Generator().manual_seed(r))
          .to(f"cuda:{r}") for r in range(cards)]
    _assert_ring_bitwise(ring_all_gather_cuda(xs), ring_all_gather_plain(xs))
    with torch.cuda.device(cards - 1):
        torch.cuda._sleep(10 ** 9)  # cycles: 0.5 s at 2 GHz or longer
    _assert_ring_bitwise(ring_all_gather_cuda(xs, timeout_s=0.2),
                         ring_all_gather_plain(xs))


# ----------------------------------------------------------------- K9, K10
def test_desc_fetch_plain_matches_loop():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((300, 8)).astype(np.float32)
    starts = rng.integers(0, 297, size=(24,)).astype(np.int32)
    got = desc_fetch_plain(torch.from_numpy(table), torch.from_numpy(starts),
                           3, rows_per_tile=12).numpy()
    want = np.stack([sum(table[s:s + 3].sum(0) for s in starts[t * 4:
                                                               (t + 1) * 4])
                     for t in range(6)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("k,rows_per_tile", [(1, 4096), (2, 4096), (4, 4096),
                                             (8, 4096), (16, 4096),
                                             (32, 4096), (3, 3072),
                                             (64, 1024)])
def test_desc_fetch_kernel_matches_plain(cuda_device, k, rows_per_tile):
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    rows = 1 << 17
    table = torch.rand((rows, 128), generator=gen, device=cuda_device)
    n = 16 * rows_per_tile // k
    starts = torch.randint(0, rows - k + 1, (n,), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    got = desc_fetch_cuda(table, starts, k, rows_per_tile)
    want = desc_fetch_plain(table, starts, k, rows_per_tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    bad = starts.clone()
    bad[5] = rows - k + 1  # one row past the table's end
    got = desc_fetch_cuda(table, bad, k, rows_per_tile)
    torch.cuda.synchronize()
    assert torch.isnan(got[0]).all() and torch.isfinite(got[1:]).all()


@pytest.mark.cuda
def test_desc_fetch_kernel_replays_from_a_graph(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.rand((1 << 16, 128), generator=gen, device=cuda_device)
    starts = torch.randint(0, (1 << 16) - 8, (4096,), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    desc_fetch_cuda(table, starts, 8)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = desc_fetch_cuda(table, starts, 8)
    starts.add_(1)
    g.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, desc_fetch_plain(table, starts, 8),
                               rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "dup64", "invalid", "ragged-end",
                                  "r_blk1", "r_blk16", "d64", "nnz30"])
def test_coalesced_bag_kernel_matches_plain(cuda_device, case):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rows = (1 << 16) + (3 if case == "ragged-end" else 0)
    dim = 64 if case == "d64" else 128
    r_blk = {"r_blk1": 1, "r_blk16": 16}.get(case, 8)
    nnz = 30 if case == "nnz30" else 32
    table = torch.rand((rows, dim), generator=gen, device=cuda_device)
    idx = torch.randint(0, rows, (1024, nnz), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    if case == "dup64":
        idx = torch.randint(0, 64, (1024, nnz), generator=gen,
                            device=cuda_device, dtype=torch.int32) * 997
    if case == "invalid":
        idx[3, 1], idx[40, 0], idx[41, 5] = -5, rows, -rows - 1
    if case == "ragged-end":
        idx[:, 0] = rows - 1 - torch.arange(1024, device=cuda_device) % 3
    plan = coalesce_plan(idx, rows, r_blk, 16)
    got = coalesced_bag_cuda(table, plan)
    want = emb_gather_plain(table, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


@pytest.mark.cuda
def test_coalesce_kernels_raise_on_what_they_do_not_take(cuda_device):
    table = torch.rand((1024, 128), device=cuda_device)
    starts = torch.zeros(512, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        desc_fetch_cuda(table.double(), starts, 8, 1024)
    with pytest.raises(ValueError, match="divide"):
        desc_fetch_cuda(table, starts, 3, 1024)
    with pytest.raises(ValueError, match="fit"):
        desc_fetch_cuda(table, starts[:8], 128, 1024)
    plan = coalesce_plan(torch.zeros((16, 4), dtype=torch.int32,
                                     device=cuda_device), 1024)
    with pytest.raises(ValueError, match="rows"):
        coalesced_bag_cuda(table[:512], plan)
    with pytest.raises(TypeError):
        coalesced_bag_cuda(table.bfloat16(), plan)


# -------------------------------------------------------- decode attention
@pytest.mark.cuda
def test_decode_attention_makes_no_f32_copy_of_the_cache(cuda_device):
    """Batch 32, llama2's 32 heads of 128, cache 2048, bf16: the call raises
    peak allocated memory by less than one f32 copy of the K cache, and
    agrees with the f32 product of the upcast operands."""
    from param_tpu_torch.ops.attention import decode_attention

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shape = (32, 32, 2048, 128)
    q = torch.randn((32, 32, 1, 128), generator=gen,
                    device=cuda_device).bfloat16()
    k = torch.randn(shape, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(shape, generator=gen, device=cuda_device).bfloat16()
    valid = torch.arange(2048, device=cuda_device) <= 2000
    decode_attention(q, k, v, valid)  # cuBLAS sets up its workspace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    assert rise < k.numel() * 4, f"peak rose {rise} B"
    assert out.dtype == torch.float32 and out.shape == (32, 32, 1, 128)
    s = torch.einsum("bkgd,bksd->bkgs", q[:4].float(), k[:4].float()) \
        / math.sqrt(128)
    p = torch.softmax(s.masked_fill(~valid, -1e30), -1).bfloat16()
    want = torch.einsum("bkgs,bksd->bkgd", p.float(), v[:4].float())
    torch.testing.assert_close(out[:4], want, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_decode_attention_on_the_card_matches_the_reference(cuda_device):
    """The card's decode attention (bf16 cache, f32 accumulation) on the
    inputs of ``tests/fixtures/decode_attention_bf16.npz`` against the
    output the reference computed there in JAX (its ``preferred_element_type``
    einsums; ``test_torch_transformer.py`` checks that the stored output is
    the reference's)."""
    import os

    from param_tpu_torch.ops.attention import decode_attention

    f = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "decode_attention_bf16.npz"))
    q, k, v = (torch.from_numpy(f[n]).view(torch.bfloat16).to(cuda_device)
               for n in ("q", "k", "v"))
    got = decode_attention(q, k, v, torch.from_numpy(f["valid"])
                           .to(cuda_device))
    assert got.dtype == torch.float32 and q.dtype == k.dtype == torch.bfloat16
    np.testing.assert_allclose(got.cpu().numpy(), f["out"], rtol=1e-3,
                               atol=1e-4)
