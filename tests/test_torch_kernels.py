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

import contextlib
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
    PATHS as FLASH_PATHS, attention_keep_mask, count_launch, flash_fwd_cuda,
    flash_fwd_plain, flash_fwd_tolerance, flash_schedule, kernel_takes,
    tma_takes,
)
from param_tpu_torch.kernels.gemm import (
    gemm_cuda, gemm_plain, gemm_schedule, gemm_wres_cuda, gemm_wres_plain,
    k_split,
)
import param_tpu_torch.kernels.int4_gemm as k5
from param_tpu_torch.kernels.int4_gemm import (
    STREAM_MAX_M, forced_path, int4_dequant, int4_gemm_cuda, int4_gemm_plain,
    int4_schedule, mma_schedule, stream_tile, takes,
)
from param_tpu_torch.kernels.ring import (
    ACROSS_BUDGET, ACROSS_SLICE_BYTES, CLUSTER_MIN_INPUT, CLUSTER_SMEM,
    L2_BUDGET, LAG, LOOPBACK_BLOCK_BYTES, MAX_BLOCKS, SLICE_BYTES, SLOTS,
    bidir_lanes, check_errors, cluster_shape, forced_route,
    ring_all_gather_bidir_cuda, ring_all_gather_bidir_plain,
    ring_all_gather_cuda, ring_all_gather_plain, ring_loopback_cuda,
    ring_loopback_plain, ring_plan, ring_reduce_scatter_cuda,
    ring_reduce_scatter_plain,
)
from param_tpu_torch.kernels.sparse_update import (
    sparse_update_cuda, sparse_update_plain,
)
from param_tpu_torch.ops.datasets import (
    ATTN_GPT2, ATTN_LLAMA2, GEMM_A, GEMM_B, GEMM_C,
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


_SMS_K5 = 132  # an H100's SMs


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


# (M, N, K) of the main path's int4 products: the decode step's four
# projections (QKV, O, FFN up, FFN down) at batch 1, 8 and 32, llama2-7B
# widths, g = 128; and the inference bench's layer at batch 512
_INT4_DECODE = [(m, n, k) for m in (1, 8, 32)
                for n, k in ((12288, 4096), (4096, 4096), (11008, 4096),
                             (4096, 11008))]


@pytest.mark.parametrize("m,n,k", _INT4_DECODE)
def test_int4_schedule_streams_the_decode_projections(m, n, k):
    path, rows, splits = int4_schedule(m, n, k // 2, 64, True, _SMS_K5)
    assert path == "stream"
    mr, bn = stream_tile(m)
    tiles = math.ceil(m / mr) * math.ceil(n / bn)
    assert tiles * splits >= _SMS_K5  # the card is filled


def test_int4_schedule_takes_wgmma_at_the_inference_batch():
    path, rows, splits = int4_schedule(512, 4096, 2048, 64, True, _SMS_K5)
    assert (path, rows, splits) == ("wgmma", 2048, 1)  # 128 tiles, one wave


@pytest.mark.parametrize("m,n,kh,gh", [
    (1, 4096, 2048, 64), (8, 11008, 2048, 64), (32, 4096, 5504, 64),
    (16, 1040, 256, 8), (5, 272, 384, 24), (2, 512, 512, 512),
    (33, 4096, 2048, 64), (128, 4096, 2048, 64), (200, 1024, 512, 32),
    (512, 11008, 2048, 64)])
def test_int4_schedule_splits_cover_k_in_whole_steps(m, n, kh, gh):
    """Stream splits are whole 64-row multiples, wgmma splits whole 32-row
    steps; every packed row has a split and every split a row; wgmma splits
    only below one wave of tiles and then stays within it."""
    path, rows, splits = int4_schedule(m, n, kh, gh, True, _SMS_K5)
    assert path == ("stream" if m <= STREAM_MAX_M else "wgmma")
    assert rows % (64 if path == "stream" else 32) == 0
    assert splits * rows >= kh and (splits - 1) * rows < kh
    if path == "wgmma":
        tiles = math.ceil(m / 128) * math.ceil(n / 128)
        assert splits == 1 if tiles >= _SMS_K5 else tiles * splits <= _SMS_K5


@pytest.mark.parametrize("m", [1, 32, 33, 512])
@pytest.mark.parametrize("gh,aligned,want", [
    (4, True, "simt"), (12, False, "simt"), (64, False, "mma_sync"),
    (8, False, "mma_sync"), (16, True, None), (64, True, None)])
def test_int4_schedule_keeps_mma_sync_and_simt_where_they_are_needed(
        m, gh, aligned, want):
    """gh % 8 != 0 takes simt, unaligned takes mma_sync; aligned shapes
    stream up to M = 32, above it wgmma needs gh % 32 == 0."""
    path = int4_schedule(m, 1024, 1024, gh, aligned, _SMS_K5)[0]
    if want is None:
        want = ("stream" if m <= STREAM_MAX_M else
                "wgmma" if gh % 32 == 0 else "mma_sync")
    assert path == want
    assert takes(path, gh, aligned)


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


def _int4_path(x, p, sc):
    """The path int4_gemm_cuda takes for these tensors, and its splits."""
    (m, k), (kh, n) = x.shape, p.shape
    aligned = (n % 16 == 0 and k % 8 == 0 and x.data_ptr() % 16 == 0
               and p.data_ptr() % 16 == 0 and sc.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    path, _, splits = int4_schedule(m, n, kh, kh // sc.shape[0], aligned, sms)
    return path, splits


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 16, 32, 33, 96, 128, 512])
@pytest.mark.parametrize("n,kh,groups", [(256, 256, 4), (200, 256, 2),
                                         (200, 250, 2), (1024, 512, 8),
                                         (136, 96, 3), (1024, 1024, 16)])
def test_int4_gemm_kernel_matches_plain(cuda_device, m, n, kh, groups):
    """Every path against the plain version; the aligned shapes (N % 16 ==
    0, gh % 8 == 0) take stream up to M = 32 and wgmma above it (gh % 32 ==
    0), (1024, 1024, 16) splits K on both; each launch moves its path's
    counter."""
    packed, scale = _packed(kh, n, groups, seed=m)
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, 2 * kh), dtype=np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    p = torch.from_numpy(packed).to(cuda_device)
    sc = torch.from_numpy(scale).to(cuda_device)
    path, splits = _int4_path(x, p, sc)
    if n % 16 == 0 and (kh // groups) % 8 == 0:
        assert path == ("stream" if m <= STREAM_MAX_M else "wgmma"), path
    if (n, kh, groups) == (1024, 1024, 16) and m <= 128:
        assert splits > 1, (m, splits)
    before = dict(kernels.launch_counts)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = int4_gemm_cuda(x, p, sc, out_dtype)
        want = int4_gemm_plain(x, p, sc, out_dtype)
        torch.cuda.synchronize()
        err, tol = _max_err_tol(got, want)
        assert err <= tol, (err, tol)
    moved = {c for c, v in kernels.launch_counts.items() if v != before[c]}
    assert moved == {"int4_gemm", f"int4_gemm_{path}"}, moved
    assert kernels.launch_counts["int4_gemm"] == before["int4_gemm"] + 2
    assert kernels.launch_counts[f"int4_gemm_{path}"] == \
        before[f"int4_gemm_{path}"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("m,path", [(1, "stream"), (8, "stream"),
                                    (32, "stream"), (128, "wgmma"),
                                    (512, "wgmma")])
def test_int4_gemm_new_paths_repeat_bitwise(cuda_device, m, path):
    """Split K is added in a fixed order by the tile's last block: two runs
    give the same bits."""
    kh, n = 1024, 1024
    packed, scale = _packed(kh, n, 16, seed=11)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((m, 2 * kh), dtype=np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    p = torch.from_numpy(packed).to(cuda_device)
    sc = torch.from_numpy(scale).to(cuda_device)
    assert _int4_path(x, p, sc)[0] == path
    first = int4_gemm_cuda(x, p, sc, torch.float32)
    second = int4_gemm_cuda(x, p, sc, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    err, tol = _max_err_tol(first, int4_gemm_plain(x, p, sc, torch.float32))
    assert err <= tol, (err, tol)


def _int4_split_case(device, m):
    """x, packed and scale of a (M, 2048) @ int4 (2048, 1024) product that
    splits K on its path (stream up to M = 32, wgmma above)."""
    packed, scale = _packed(1024, 1024, 16, seed=13)
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((m, 2048), dtype=np.float32))
    return (x.to(device, torch.bfloat16), torch.from_numpy(packed).to(device),
            torch.from_numpy(scale).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 32, 128])
def test_int4_gemm_split_k_on_two_streams_at_once(cuda_device, m):
    """Split-K launches on two streams may overlap: each stream keeps its
    own arrival counters, so every result has one stream's bits."""
    x, p, sc = _int4_split_case(cuda_device, m)
    path, splits = _int4_path(x, p, sc)
    assert splits > 1 and path == ("stream" if m <= 32 else "wgmma")
    want = int4_gemm_cuda(x, p, sc, torch.float32)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(int4_gemm_cuda(x, p, sc, torch.float32))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 128])
def test_int4_gemm_replays_from_a_cuda_graph(cuda_device, m):
    """A split-K launch captured on a warmed-up stream replays with the
    same bits, also beside eager launches on another stream."""
    x, p, sc = _int4_split_case(cuda_device, m)
    want = int4_gemm_cuda(x, p, sc, torch.float32)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        int4_gemm_cuda(x, p, sc, torch.float32)  # the stream's counters
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        out = int4_gemm_cuda(x, p, sc, torch.float32)
    eager = []
    for _ in range(5):
        g.replay()
        eager.append(int4_gemm_cuda(x, p, sc, torch.float32))
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert all(torch.equal(e, want) for e in eager)


def test_forced_path_nests_and_restores():
    assert k5._forced is None
    with forced_path("mma_sync"):
        assert k5._forced == "mma_sync"
        with forced_path("stream"):
            assert k5._forced == "stream"
        assert k5._forced == "mma_sync"
    assert k5._forced is None
    with pytest.raises(RuntimeError), forced_path("wgmma"):
        raise RuntimeError
    assert k5._forced is None


@pytest.mark.parametrize("path", ["tiles", "", "STREAM", None])
def test_forced_path_refuses_unknown_paths(path):
    with pytest.raises(ValueError):
        with forced_path(path):
            pass
    assert k5._forced is None


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
    # K5's stream and wgmma paths refuse what 16-byte copies and TMA cannot
    # describe (N % 16 != 0) and groups that are not whole k16 / K steps
    x = torch.ones((4, 64), device=cuda_device, dtype=torch.bfloat16)
    odd = torch.zeros((32, 24), dtype=torch.int8, device=cuda_device)
    for path in ("stream", "wgmma"):
        with forced_path(path), pytest.raises(ValueError):
            int4_gemm_cuda(x, odd, torch.ones((1, 24), device=cuda_device))
    p = torch.zeros((32, 32), dtype=torch.int8, device=cuda_device)
    with forced_path("stream"), pytest.raises(ValueError):  # gh 4
        int4_gemm_cuda(x, p, torch.ones((8, 32), device=cuda_device))
    with forced_path("wgmma"), pytest.raises(ValueError):  # gh 16
        int4_gemm_cuda(x, p, torch.ones((2, 32), device=cuda_device))
    with pytest.raises(ValueError):
        with forced_path("tiles"):
            int4_gemm_cuda(x, p, torch.ones((2, 32), device=cuda_device))


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


def _fused_heads(y, h, hkv, d):
    """q, k, v as the strided head views of one (b, s, (h + 2 hkv) d)
    projection ``y``, as the transformer block hands them to K6 / K7."""
    b, s = y.shape[:2]
    q, k, v = y.split([h * d, hkv * d, hkv * d], dim=-1)
    return (q.reshape(b, s, h, d).transpose(1, 2),
            k.reshape(b, s, hkv, d).transpose(1, 2),
            v.reshape(b, s, hkv, d).transpose(1, 2))


def _dense_heads(b, h, hkv, s, d, dtype):
    return (torch.empty((b, h, s, d), dtype=dtype),
            torch.empty((b, hkv, s, d), dtype=dtype),
            torch.empty((b, hkv, s, d), dtype=dtype))


# (name, q / k / v views, the path K6 and K7 take for them)
_SCHEDULE_CASES = (
    [(f"llama2 {shape} {str(dt)[6:]}", lambda s=shape, dt=dt: _dense_heads(
        s[0], s[1], s[1], s[2], s[3], dt), "wgmma")
     for shape in ATTN_LLAMA2 for dt in (torch.bfloat16, torch.float16)]
    + [(f"gpt2 {shape}", lambda s=shape: _dense_heads(
        s[0], s[1], s[1], s[2], s[3], torch.bfloat16), "wgmma")
       for shape in ATTN_GPT2]
    + [("gqa 32 / 8 heads", lambda: _dense_heads(1, 32, 8, 2048, 128,
                                                 torch.bfloat16), "wgmma"),
       ("train step's fused projection, D 128",
        lambda: _fused_heads(torch.empty((1, 2048, 3 * 4096),
                                         dtype=torch.bfloat16), 32, 32, 128),
        "wgmma"),
       ("fused projection, D 64, gqa",
        lambda: _fused_heads(torch.empty((2, 130, 12 * 64),
                                         dtype=torch.float16), 8, 2, 64),
        "wgmma"),
       ("head dim 32", lambda: _dense_heads(4, 16, 16, 1024, 32,
                                            torch.bfloat16), "mma_sync"),
       ("f32", lambda: _dense_heads(1, 4, 4, 512, 64, torch.float32),
        "tf32x3"),
       ("f32 head dim 128", lambda: _dense_heads(1, 4, 4, 512, 128,
                                                 torch.float32), "tf32x3"),
       ("f32 llama2 (1, 32, 2048, 128)", lambda: _dense_heads(
           1, 32, 32, 2048, 128, torch.float32), "tf32x3"),
       ("f32 gpt2 (8, 12, 1024, 64)", lambda: _dense_heads(
           8, 12, 12, 1024, 64, torch.float32), "tf32x3"),
       ("f32 fused projection, row stride not 16-byte aligned",
        lambda: _fused_heads(torch.empty((2, 130, 12 * 64 + 1),
                                         dtype=torch.float32)[..., :-1],
                             8, 2, 64), "tf32x3"),
       ("expanded batch (zero stride)",
        lambda: tuple(t.expand(2, -1, -1, -1) for t in _dense_heads(
            1, 4, 4, 64, 64, torch.bfloat16)), "mma_sync")])


@pytest.mark.parametrize("name,views,path", _SCHEDULE_CASES,
                         ids=[c[0] for c in _SCHEDULE_CASES])
def test_flash_schedule_picks_the_path(name, views, path):
    """What K6 and K7 would launch for these q / k / v views (the window
    does not change the path, so the llama2 rows stand for it too)."""
    q, k, v = views()
    assert all(kernel_takes(t) for t in (q, k, v)), name
    aligned = all(tma_takes(t) for t in (q, k, v))
    assert flash_schedule(q.dtype, q.shape[-1], aligned) == path


@pytest.mark.parametrize("d", [64, 128])
def test_flash_schedule_keeps_wgmma_off_views_tma_cannot_read(d):
    """A row stride that is no multiple of 8 elements (16 bytes): no TMA
    map describes it, so the schedule does not send it to wgmma; no kernel
    reads it (the wrappers refuse it, and flash_mha's backward copies it
    first)."""
    x = torch.zeros((1, 64, 4 * d + 4), dtype=torch.bfloat16)
    q = x[..., :4 * d].reshape(1, 64, 4, d).transpose(1, 2)
    assert q.stride(2) % 8 and not tma_takes(q) and not kernel_takes(q)
    assert flash_schedule(q.dtype, d, tma_takes(q)) == "mma_sync"
    assert flash_schedule(q.dtype, d, True) == "wgmma"


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd"])
@pytest.mark.parametrize("path", list(FLASH_PATHS))
def test_flash_path_counters_stay_in_step_with_the_totals(kernel, path):
    kernels.reset_launch_counts()
    for p in list(FLASH_PATHS) + [path]:
        count_launch(kernel, p)
    per_path = {p: kernels.launch_counts[f"{kernel}_{p}"] for p in FLASH_PATHS}
    assert kernels.launch_counts[kernel] == sum(per_path.values()) == 4
    assert per_path[path] == 2
    kernels.reset_launch_counts()


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


def _flash_path(dtype, d):
    """The path K6 / K7 must take for dense inputs."""
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if d in (64, 128) else "mma_sync"


# ---------------------------------------- the tf32x3 path's arithmetic
def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the bits: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32x3(a, b):
    """a @ b as the tf32x3 path takes it: each operand split into hi =
    tf32(x) and lo = tf32(x - hi), three TF32 products summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """a @ b as one TF32 product: what the tf32x3 path must not be."""
    return _tf32(a) @ _tf32(b)


def _k6_split(q, k, v, causal, window, mm, bn=64):
    """K6's f32 recurrence on the CPU with its products taken by ``mm``:
    kv tiles of ``bn`` columns, scores times scale log2(e), the online
    softmax in exp2, O / l and the natural-log lse at the end."""
    b, h, sq, d = q.shape
    sk, group = k.shape[2], h // k.shape[1]
    kf, vf = (t.repeat_interleave(group, dim=1) for t in (k, v))
    sl2 = math.log2(math.e) / math.sqrt(d)
    keep = attention_keep_mask(sq, sk, causal, window, "cpu")
    m = torch.full((b, h, sq), -math.inf)
    l, o = torch.zeros((b, h, sq)), torch.zeros((b, h, sq, d))
    for c0 in range(0, sk, bn):
        s = mm(q, kf[:, :, c0:c0 + bn].transpose(-1, -2)) * sl2
        if keep is not None:
            s = s.masked_fill(~keep[:, c0:c0 + bn], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vf[:, :, c0:c0 + bn])
        m = m_new
    return o / l[..., None], (m + torch.log2(l)) * math.log(2)


def _k7_split(q, k, v, o, lse, do, causal, mm):
    """K7's five f32 products on the CPU taken by ``mm``; P, D and dS in
    f32 as the kernel forms them."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    kf, vf = (t.repeat_interleave(group, dim=1) for t in (k, v))
    scale = 1.0 / math.sqrt(d)
    s = mm(q, kf.transpose(-1, -2))
    p = torch.exp2(s * scale * math.log2(math.e)
                   - lse[..., None] * math.log2(math.e))
    keep = attention_keep_mask(sq, sk, causal, None, "cpu")
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = mm(do, vf.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(-1, keepdim=True)) * scale

    def gsum(t):
        return t.reshape(b, hkv, group, sk, d).sum(2)

    return (mm(ds, kf), gsum(mm(ds.transpose(-1, -2), q)),
            gsum(mm(p.transpose(-1, -2), do)))


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    x = torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2.0 ** -23),
                   one * (1 + 3 * ulp / 2)])
    want = torch.cat([one * (1 + ulp), one, one * (1 + 2 * ulp)])
    assert torch.equal(_tf32(x), want)
    # hi + lo recovers x to about 2^-22 relative
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096, dtype=np.float32))
    hi = _tf32(x)
    err = (hi + _tf32(x - hi) - x).abs() / x.abs()
    assert err.max().item() <= 2.0 ** -21 and (hi != x).any()


# (B, H, H_kv, S_q, S_k, D, causal, window): a few heads, S <= 256
_SPLIT_CASES = [
    (1, 4, 4, 256, 256, 128, True, None),
    (2, 2, 2, 192, 192, 64, False, None),
    (1, 4, 2, 256, 256, 64, True, None),
    (1, 2, 1, 100, 256, 128, True, None),
    (2, 4, 4, 128, 128, 32, True, None),
]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", _SPLIT_CASES + [
    (1, 2, 2, 256, 256, 64, True, 96)])
def test_tf32x3_split_holds_k6_bounds_one_tf32_product_does_not(
        b, h, hkv, sq, sk, d, causal, window):
    """K6's f32 arithmetic with split-TF32 products stays within the f32
    bounds (2e-5 on O, 1e-4 on the lse) of the plain version; the same
    recurrence with single TF32 products does not."""
    q, k, v = _attn(b, h, hkv, sq, sk, d, seed=sq + d)
    want, want_lse = flash_fwd_plain(q, k, v, causal, None, window, True)
    tol = flash_fwd_tolerance(q, k, v, want, causal, None, window)
    got, lse = _k6_split(q, k, v, causal, window, _mm_tf32x3)
    assert ((got - want).abs() <= tol).all(), ((got - want).abs() / tol).max()
    assert (lse - want_lse).abs().max().item() <= 1e-4
    one, _ = _k6_split(q, k, v, causal, window, _mm_tf32)
    assert ((one - want).abs() > tol).any()


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", _SPLIT_CASES)
def test_tf32x3_split_holds_k7_bounds_one_tf32_product_does_not(
        b, h, hkv, sq, sk, d, causal, window):
    """K7's five products split-TF32 stay within the f32 bounds
    (``flash_bwd_tolerance``) of the plain version on dq, dk and dv; single
    TF32 products miss them on each."""
    ins = _bwd_inputs(b, h, hkv, sq, sk, d, causal, seed=sq + d)
    want = flash_bwd_plain(*ins, causal)
    tols = flash_bwd_tolerance(*ins, want, causal)
    for got, w, tol in zip(_k7_split(*ins, causal, _mm_tf32x3), want, tols):
        assert ((got - w).abs() <= tol).all(), ((got - w).abs() / tol).max()
    for got, w, tol in zip(_k7_split(*ins, causal, _mm_tf32), want, tols):
        assert ((got - w).abs() > tol).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", _K6_CASES)
def test_flash_fwd_kernel_matches_plain(cuda_device, dtype, b, h, hkv, sq, sk,
                                        d, causal, window):
    q, k, v = (t.to(cuda_device, dtype) for t in _attn(b, h, hkv, sq, sk, d,
                                                        seed=sq + d))
    path = _flash_path(dtype, d)
    before = kernels.launch_counts["flash_fwd"]
    on_path = kernels.launch_counts[f"flash_fwd_{path}"]
    got, lse = flash_fwd_cuda(q, k, v, causal, None, window, return_lse=True)
    want, want_lse = flash_fwd_plain(q, k, v, causal, None, window,
                                     return_lse=True)
    assert flash_fwd_cuda(q, k, v, causal, None, window).shape == got.shape
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_fwd"] == before + 2
    assert kernels.launch_counts[f"flash_fwd_{path}"] == on_path + 2
    assert got.dtype == dtype and got.shape == (b, h, sq, d)
    tol = flash_fwd_tolerance(q, k, v, want, causal, None, window)
    diff = (got.float() - want.float()).abs()
    assert (diff <= tol).all(), (diff / tol).max().item()
    assert diff.max().item() <= (2e-5 if dtype == torch.float32 else 2e-2)
    assert (lse - want_lse).abs().max().item() <= 1e-4


def _fused_random(b, s, h, hkv, d, dtype, device, seed):
    """q, k, v: strided head views of one random (b, s, (h + 2 hkv) d)
    projection; do: the transposed-head view of a random (b, s, h d)
    gradient (the layouts the transformer block passes to K6 / K7)."""
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((b, s, (h + 2 * hkv) * d),
                                             dtype=np.float32))
    q, k, v = _fused_heads(y.to(device, dtype), h, hkv, d)
    g = torch.from_numpy(rng.standard_normal((b, s, h * d), dtype=np.float32))
    do = g.to(device, dtype).reshape(b, s, h, d).transpose(1, 2)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,hkv", [(64, 4), (128, 4), (128, 2), (32, 4)])
def test_flash_fwd_kernel_takes_strided_heads(cuda_device, dtype, d, hkv):
    """Heads split out of a fused (B, S, (H + 2 H_kv) D) projection, as the
    transformer block passes them, with no copy, on the path the schedule
    gives dense inputs (f32: tf32x3; 16-bit: wgmma at D 64 and 128,
    mma_sync at 32)."""
    b, s, h = 2, 130, 4
    q, k, v, _ = _fused_random(b, s, h, hkv, d, dtype, cuda_device, seed=5)
    assert not q.is_contiguous()
    path = _flash_path(dtype, d)
    on_path = kernels.launch_counts[f"flash_fwd_{path}"]
    got = flash_fwd_cuda(q, k, v, causal=True)
    want = flash_fwd_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts[f"flash_fwd_{path}"] == on_path + 1
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
    x = torch.ones((1, 2, 16, 96), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_fwd_cuda(x, x, x)
    x = torch.ones((1, 2, 64, 64), device=cuda_device)
    with pytest.raises(TypeError):
        flash_fwd_cuda(x, x.half(), x)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_cuda(x.transpose(2, 3), x, x)


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
    path = _flash_path(dtype, d)
    before = kernels.launch_counts["flash_bwd"]
    on_path = kernels.launch_counts[f"flash_bwd_{path}"]
    got = flash_bwd_cuda(*ins, causal)
    want = flash_bwd_plain(*ins, causal)
    tols = flash_bwd_tolerance(*ins, want, causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_bwd"] == before + 1
    assert kernels.launch_counts[f"flash_bwd_{path}"] == on_path + 1
    for g, w, tol in zip(got, want, tols):
        assert g.dtype == dtype and g.shape == w.shape and g.is_contiguous()
        diff = (g.float() - w.float()).abs()
        assert (diff <= tol).all(), (diff / tol).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,hkv", [(64, 4), (128, 4), (128, 2), (32, 4)])
def test_flash_bwd_kernel_takes_strided_heads(cuda_device, dtype, d, hkv):
    """q, k, v split out of a fused (B, S, (H + 2 H_kv) D) projection and dO
    the transposed-head gradient of (B, S, H D), as the block passes them,
    on the path the schedule gives dense inputs."""
    b, s, h = 2, 130, 4
    q, k, v, do = _fused_random(b, s, h, hkv, d, dtype, cuda_device, seed=6)
    assert not q.is_contiguous() and not do.is_contiguous()
    path = _flash_path(dtype, d)
    o, lse = flash_fwd_cuda(q, k, v, True, return_lse=True)
    on_path = kernels.launch_counts[f"flash_bwd_{path}"]
    got = flash_bwd_cuda(q, k, v, o, lse, do, True)
    dense = [t.contiguous() for t in (q, k, v, o)] + [lse, do.contiguous()]
    want = flash_bwd_plain(*dense, True)
    tols = flash_bwd_tolerance(*dense, want, True)
    torch.cuda.synchronize()
    assert kernels.launch_counts[f"flash_bwd_{path}"] == on_path + 1
    for x, w, tol in zip(got, want, tols):
        assert ((x.float() - w.float()).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 4, 4, 256, 256, 128, True), (1, 4, 2, 200, 300, 64, True),
    (2, 3, 3, 192, 192, 64, False)])
def test_flash_bwd_is_the_same_from_run_to_run(cuda_device, dtype, b, h, hkv,
                                               sq, sk, d, causal):
    """No atomics: two K7 runs on the same inputs give bitwise-equal dq,
    dk and dv."""
    ins = _bwd_inputs(b, h, hkv, sq, sk, d, causal, dtype, seed=7,
                      device=cuda_device)
    first = flash_bwd_cuda(*ins, causal)
    second = flash_bwd_cuda(*ins, causal)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_f32_reads_views_16_byte_copies_cannot(cuda_device, d):
    """f32 heads of a fused projection whose rows are one element wider
    than (H + 2 H_kv) D: no row stride is 16-byte aligned, so K6 and K7
    copy with 4-byte cp.async, on the tf32x3 path, and agree with the
    plain versions within the f32 bounds."""
    b, s, h, hkv = 2, 130, 4, 2
    rng = np.random.default_rng(d)
    y = torch.from_numpy(rng.standard_normal(
        (b, s, (h + 2 * hkv) * d + 1), dtype=np.float32)).to(cuda_device)
    q, k, v = _fused_heads(y[..., 1:], h, hkv, d)
    g = torch.from_numpy(rng.standard_normal((b, s, h * d + 1),
                                             dtype=np.float32))
    do = g.to(cuda_device)[..., 1:].reshape(b, s, h, d).transpose(1, 2)
    assert q.stride(2) % 4 and q.data_ptr() % 16 and do.data_ptr() % 16
    fwd = kernels.launch_counts["flash_fwd_tf32x3"]
    bwd = kernels.launch_counts["flash_bwd_tf32x3"]
    o, lse = flash_fwd_cuda(q, k, v, True, return_lse=True)
    got = flash_bwd_cuda(q, k, v, o, lse, do, True)
    dense = [t.contiguous() for t in (q, k, v)]
    want_o, want_lse = flash_fwd_plain(*dense, True, return_lse=True)
    ins = dense + [o, lse, do.contiguous()]
    want = flash_bwd_plain(*ins, True)
    tols = flash_bwd_tolerance(*ins, want, True)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_fwd_tf32x3"] == fwd + 1
    assert kernels.launch_counts["flash_bwd_tf32x3"] == bwd + 1
    assert (o - want_o).abs().max().item() <= 2e-5
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for x, w, tol in zip(got, want, tols):
        assert ((x - w).abs() <= tol).all(), ((x - w).abs() / tol).max()


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
    q, k, v, o, lse, do = _bwd_inputs(1, 2, 2, 64, 64, 64, True,
                                      device=cuda_device)
    with pytest.raises(TypeError, match="lse"):
        flash_bwd_cuda(q, k, v, o, lse.double(), do)
    with pytest.raises(TypeError):
        flash_bwd_cuda(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd_cuda(q, k, v, o.transpose(2, 3), lse, do)
    x = x.float()
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

    # 16 KiB a rank, and n x 4 MiB a rank: K8b's cluster route for n >= 2
    for rows in (n * 1024, n * 262144):
        xs = _ring_shards(n, (rows, 4), torch.float32, cuda_device, seed=3)
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
    # K8a with the all-reduce's shift of one, and ring_all_reduce (K8b then
    # K8a) as a whole, captured and replayed
    from param_tpu_torch.ops.ring_collectives import ring_all_reduce

    # and K8b on its cluster route
    ring_all_gather_cuda(xs, shift=1, check=False)
    ring_all_reduce(xs)
    with forced_route("cluster"):
        ring_reduce_scatter_cuda(xs, check=False)
    check_errors(xs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gathered = ring_all_gather_cuda(xs, shift=1, check=False)
        reduced = ring_all_reduce(xs)
        with forced_route("cluster"):
            clustered = ring_reduce_scatter_cuda(xs, check=False)
    for step in range(3):
        for x in xs:
            x.mul_(-0.5).add_(0.25)
        graph.replay()
        check_errors(xs)
        _assert_ring_bitwise(gathered, ring_all_gather_plain(xs, shift=1))
        _assert_ring_bitwise([r.cpu() for r in reduced],
                             ring_all_reduce([x.cpu() for x in xs]))
        _assert_ring_bitwise(clustered, ring_reduce_scatter_plain(xs))



@pytest.mark.cuda
def test_ring_copies_repeat_and_replay_from_a_graph(cuda_device):
    """K8d and the one-rank copy hand tiles out from a per-rank ticket
    counter that the launch's last ticket resets: calls whose block counts
    differ, calls on both kernels in turn, odd counts (the word copy) and
    CUDA-graph replays must all stay right."""
    for n, shape in ((1, (3 << 20,)), (1, (40000,)), (8, (1 << 20,)),
                     (1, (3 << 20,)), (1, (12345,)), (2, (777777,)),
                     (1, (3 << 20,))):
        xs = _ring_shards(n, shape, torch.float32, cuda_device, seed=n)
        _assert_ring_bitwise(ring_loopback_cuda(xs), ring_loopback_plain(xs))
        if n == 1:
            _assert_ring_bitwise(ring_all_gather_cuda(xs),
                                 ring_all_gather_plain(xs))
    xs = _ring_shards(1, (3 << 20,), torch.float32, cuda_device)
    ring_loopback_cuda(xs, check=False)  # warm up outside the capture
    ring_all_gather_cuda(xs, check=False)
    check_errors(xs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        looped = ring_loopback_cuda(xs, check=False)
        copied = ring_all_gather_cuda(xs, check=False)
    for _ in range(3):
        xs[0].mul_(-0.5).add_(0.25)
        graph.replay()
        check_errors(xs)
        _assert_ring_bitwise(looped, ring_loopback_plain(xs))
        _assert_ring_bitwise(copied, ring_all_gather_plain(xs))


# K8a-c's plan: pure, so checked on the CPU
_SLICED = ("all_gather", "reduce_scatter", "bidir")
_COUNTERS = {"all_gather": "ring_all_gather",
             "reduce_scatter": "ring_reduce_scatter",
             "bidir": "ring_bidir_all_gather"}


def _plan_slices(plan, chunk):
    """(offset, bytes) of every slice of ``plan``, block by block, as the
    kernels walk them: block b over [b per_block, (b + 1) per_block), cut
    into slices of slice_bytes, the last one ragged."""
    out = []
    for b in range(plan.blocks):
        lo = b * plan.per_block
        hi = min(lo + plan.per_block, chunk)
        out.append([(o, min(plan.slice_bytes, hi - o))
                    for o in range(lo, hi, plan.slice_bytes)])
    return out


@pytest.mark.parametrize("kind", _SLICED)
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("chunk", [2, 16, 4096, 4098, 3 * SLICE_BYTES + 48,
                                   (1 << 20) + 6, 64 << 20])
@pytest.mark.parametrize("clusters", [0, 45])
def test_ring_plan_slices_tile_the_chunk(kind, n, chunk, clusters):
    """The slices cover the chunk once, in order, each a 16-byte multiple
    but the chunk's last, none longer than the plan's slice (on K8b's
    cluster route too, where ``clusters`` of it fit)."""
    plan = ring_plan(kind, chunk, n, 264, one_card=True,
                     cluster_capacity=clusters)
    assert plan.per_block % 16 == 0 and plan.per_block > 0
    assert plan.slice_bytes & (plan.slice_bytes - 1) == 0
    pos = 0
    slices = [s for blk in _plan_slices(plan, chunk) for s in blk]
    assert len(_plan_slices(plan, chunk)) == plan.blocks
    for i, (off, size) in enumerate(slices):
        assert off == pos and 0 < size <= plan.slice_bytes
        assert off % 16 == 0
        assert size % 16 == 0 or i == len(slices) - 1
        pos += size
    assert pos == chunk
    # only the last block may be short: every other one is whole slices
    for blk in _plan_slices(plan, chunk)[:-1]:
        assert sum(size for _, size in blk) == plan.per_block


@pytest.mark.parametrize("kind", _SLICED)
@pytest.mark.parametrize("one_card", [True, False])
@pytest.mark.parametrize("capacity,max_blocks", [(16, 256), (264, 256),
                                                 (528, 256), (4096, 8)])
def test_ring_plan_respects_capacity_and_max_blocks(kind, one_card, capacity,
                                                    max_blocks):
    for n in (1, 2, 4, 8, 16):
        ranks_here = n if one_card else 1
        for chunk in (4096, 1 << 20, 64 << 20):
            plan = ring_plan(kind, chunk, n, capacity, one_card, max_blocks)
            assert 1 <= plan.blocks <= max_blocks
            assert plan.blocks * ranks_here <= capacity
    with pytest.raises(RuntimeError, match="resident"):
        ring_plan(kind, 1 << 20, 8, 7, one_card=True)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("one_card", [True, False])
def test_ring_plan_workspace_does_not_grow_with_the_chunk(n, one_card):
    """K8b's slots a rank on the memory route: blocks x (n - 1) x slots x
    S, within the budget whatever the chunk (on one card the L2 budget
    over its n ranks, across cards ACROSS_BUDGET), and the same from 256
    MiB to 1 GiB a chunk; the gathers need none."""
    sizes = [ring_plan("reduce_scatter", c << 20, n, 528, one_card)
             .workspace_bytes for c in (4, 64, 256, 1024)]
    assert len(set(sizes[2:])) == 1
    assert 0 < max(sizes) <= (L2_BUDGET // n if one_card else ACROSS_BUDGET)
    plan = ring_plan("reduce_scatter", 64 << 20, n, 528, one_card)
    assert plan.workspace_bytes == (plan.blocks * (n - 1) * plan.slots *
                                    plan.slice_bytes)
    assert plan.slots > plan.lag
    assert ring_plan("all_gather", 64 << 20, n, 528,
                     one_card).workspace_bytes == 0


@pytest.mark.parametrize("kind", ["all_gather", "reduce_scatter", "bidir",
                                  "loopback"])
def test_ring_plan_scope_follows_where_the_ranks_are(kind):
    assert ring_plan(kind, 1 << 20, 4, 528, one_card=True).scope == "gpu"
    assert ring_plan(kind, 1 << 20, 4, 528, one_card=False).scope == "sys"
    assert ring_plan(kind, 1 << 20, 1, 528, one_card=True).scope == "gpu"


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_plan_cluster_route(n):
    """K8b with 2 to 8 ranks on one card takes the cluster route where a
    cluster fits: its slots are in shared memory (no workspace, the slots
    within CLUSTER_SMEM), more slots than the lag, up to one block a
    cluster that fits; the memory route everywhere else."""
    plan = ring_plan("reduce_scatter", 64 << 20, n, 264, True,
                     cluster_capacity=45)
    size, slots, smem = cluster_shape(n)
    assert plan.route == "cluster" and plan.workspace_bytes == 0
    assert (plan.slice_bytes, plan.slots) == (size, slots)
    assert smem == (n - 1) * slots * size <= CLUSTER_SMEM
    assert plan.slots > plan.lag and plan.blocks <= 45
    # from CLUSTER_MIN_INPUT input bytes a rank, or when forced
    chunk = -(-CLUSTER_MIN_INPUT // n)
    for size, route in ((chunk, "cluster"), (chunk - 16, "memory")):
        assert ring_plan("reduce_scatter", size, n, 264, True,
                         cluster_capacity=45).route == route
    assert ring_plan("reduce_scatter", 4096, n, 264, True,
                     cluster_capacity=45, route="cluster").route == "cluster"
    for kind, card, clusters in (("all_gather", True, 45),
                                 ("reduce_scatter", False, 45),
                                 ("reduce_scatter", True, 0)):
        assert ring_plan(kind, 64 << 20, n, 264, card,
                         cluster_capacity=clusters).route == "memory"
    for card, clusters in ((False, 45), (True, 0)):
        with pytest.raises(ValueError, match="cluster route"):
            ring_plan("reduce_scatter", 64 << 20, n, 264, card,
                      cluster_capacity=clusters, route="cluster")
    assert ring_plan("reduce_scatter", 64 << 20, n, 264, True,
                     cluster_capacity=45, route="memory").route == "memory"


@pytest.mark.parametrize("n", [1, 9, 16])
def test_ring_plan_cluster_route_only_for_2_to_8_ranks(n):
    plan = ring_plan("reduce_scatter", 64 << 20, n, 528, True,
                     cluster_capacity=45)
    assert plan.route == ("copy" if n == 1 else "memory")
    assert plan.workspace_bytes == plan.blocks * (n - 1) * plan.slots * \
        plan.slice_bytes


def test_ring_plan_options_and_what_it_refuses():
    """The slices, lag and slots are the module's constants; the plan
    refuses what the kernels cannot take."""
    for one_card, size in ((True, SLICE_BYTES), (False, ACROSS_SLICE_BYTES)):
        plan = ring_plan("reduce_scatter", 64 << 20, 4, 528, one_card)
        assert (plan.slice_bytes, plan.lag, plan.slots) == (size, LAG, SLOTS)
        assert ring_plan("all_gather", 64 << 20, 4, 528,
                         one_card).slots == 0
    assert SLOTS > LAG
    with pytest.raises(ValueError, match="ranks"):
        ring_plan("all_gather", 1 << 20, 17, 528, True)
    with pytest.raises(ValueError, match="unknown ring kernel"):
        ring_plan("all_to_all", 1 << 20, 4, 528, True)
    with pytest.raises(ValueError, match="unknown K8b route"):
        ring_plan("reduce_scatter", 1 << 20, 4, 528, True, route="copy")
    with pytest.raises(ValueError, match="cluster route"):
        ring_plan("reduce_scatter", 1 << 20, 9, 528, True,
                  cluster_capacity=45, route="cluster")
    # K8c: K8a's slices (n - 1 hops a step), on one card and across cards;
    # over one rank the copy
    for one_card in (True, False):
        for n in (2, 3, 8):
            plan = ring_plan("bidir", 1 << 20, n, 528, one_card)
            gather = ring_plan("all_gather", 1 << 20, n, 528, one_card)
            assert plan.sliced and plan.route == "memory"
            assert (plan.blocks, plan.per_block, plan.slice_bytes, plan.lag,
                    plan.slots) == (gather.blocks, gather.per_block,
                                    gather.slice_bytes, gather.lag, 0)
    assert ring_plan("bidir", 1 << 20, 1, 528, True).route == "copy"
    # at n = 4 K8c's step is two jobs (hop 0 serves both directions), so
    # its slice is twice K8a's, whose step is three hops
    assert ring_plan("bidir", 1 << 20, 4, 528, True).slice_bytes == \
        2 * ring_plan("all_gather", 1 << 20, 4, 528, True).slice_bytes
    # K8d: one range a block, LOOPBACK_BLOCK_BYTES a block up to the
    # capacity
    assert ring_plan("loopback", 64 << 20, 1, 528, True).blocks == min(
        528, MAX_BLOCKS)


@pytest.mark.parametrize("n", range(1, 17))
def test_ring_bidir_hops_deliver_every_chunk_once(n):
    """K8c's lanes (as ``csrc/ring.cu`` plans them) walked on n ranks: every
    rank gets every other rank's chunk exactly once, clockwise from the
    left or counter-clockwise from the right, in the reference's order
    (``_bidir_all_gather_kernel``: step i brings chunk r - i - 1 clockwise
    and r + i + 1 counter-clockwise); a hop forwards only what arrived at
    the hop before it in its direction; a step has at most n - 1 hops and
    a slice's longest chain is n // 2 hops."""
    cw, ccw = n // 2, (n - 1) // 2
    lanes = bidir_lanes(n)
    assert len(lanes) <= 16 and lanes == sorted(set(lanes))
    got = {r: {} for r in range(n)}  # rank -> (dir, hop) -> (chunk, sender)
    for step in range(cw):  # hop ``step`` of every lane that has one
        for r in range(n):
            for d, hop in lanes:
                if hop != step:
                    continue
                # what the lane sends: its input at hop 0, else what came
                # in at the hop before it in its direction
                c = r if hop == 0 else got[r][(d, hop - 1)][0]
                assert c == ((r - hop) % n if d == 0 else (r + hop) % n)
                sends = [(d, (r + 1) % n if d == 0 else (r - 1) % n)]
                if (d, hop) == (0, 0) and ccw >= 1:  # one job, both hops 0
                    sends.append((1, (r - 1) % n))
                for d2, to in sends:
                    assert (d2, hop) not in got[to]
                    got[to][(d2, hop)] = (c, r)
    hops_a_step = sum(1 + ((d, h) == (0, 0) and ccw >= 1) for d, h in lanes)
    assert hops_a_step == n - 1
    assert max([h + 1 for _, h in lanes], default=0) == cw
    for r in range(n):
        assert sorted(got[r]) == ([(0, i) for i in range(cw)] +
                                  [(1, i) for i in range(ccw)])
        for (d, i), (c, sender) in got[r].items():
            assert c == ((r - i - 1) % n if d == 0 else (r + i + 1) % n)
            assert sender == ((r - 1) % n if d == 0 else (r + 1) % n)
        chunks = sorted(c for c, _ in got[r].values())
        assert chunks == sorted(set(range(n)) - {r})


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("one_card", [True, False])
@pytest.mark.parametrize("capacity", [16, 264, 528, 4096])
@pytest.mark.parametrize("sms", [0, 132])
def test_ring_loopback_plan_fills_the_capacity(n, one_card, capacity, sms):
    """K8d's plan: one range a block, LOOPBACK_BLOCK_BYTES a block, up to
    the blocks that fit on the card at once (every block spins on the
    neighbour barrier), ``max_blocks`` and one block an SM a rank (where
    ``sms`` is given); so a large chunk takes all the blocks it may.  The
    ranges tile the chunk in 16-byte multiples."""
    ranks_here = n if one_card else 1
    if capacity < ranks_here:
        with pytest.raises(RuntimeError, match="resident"):
            ring_plan("loopback", 1 << 20, n, capacity, one_card)
        return
    for chunk in (16, 4096, 4098, 1 << 20, (1 << 20) + 6, 64 << 20):
        for max_blocks in (MAX_BLOCKS, 8):
            plan = ring_plan("loopback", chunk, n, capacity, one_card,
                             max_blocks, sms=sms)
            cap = min(max_blocks, capacity // ranks_here, sms or capacity)
            assert plan.blocks * ranks_here <= capacity
            assert 1 <= plan.blocks <= min(cap,
                                           -(-chunk // LOOPBACK_BLOCK_BYTES))
            assert plan.per_block % 16 == 0 and plan.per_block >= 16
            assert (plan.blocks - 1) * plan.per_block < chunk
            assert plan.blocks * plan.per_block >= chunk
            if chunk >= cap * LOOPBACK_BLOCK_BYTES:
                assert plan.blocks == cap
            assert not plan.sliced and plan.route == "memory"
            assert plan.scope == ("gpu" if one_card else "sys")


def test_forced_route_nests_and_restores():
    from param_tpu_torch.kernels import ring

    assert ring._forced_route is None
    with forced_route("cluster"):
        assert ring._forced_route == "cluster"
        with forced_route("memory"):
            assert ring._forced_route == "memory"
        assert ring._forced_route == "cluster"
    assert ring._forced_route is None
    with pytest.raises(RuntimeError), forced_route("memory"):
        raise RuntimeError("left through an exception")
    assert ring._forced_route is None


@pytest.mark.parametrize("route", ["copy", "global", "", None])
def test_forced_route_refuses_unknown_routes(route):
    with pytest.raises(ValueError, match="unknown K8b route"):
        with forced_route(route):
            pass


def _slice_cases(kind, n):
    """(shard shape, forced K8b route) crossing slice boundaries around the
    default slice (8 KiB; 16 KiB where a step has at most two hops): a
    chunk under one slice, an odd 2-byte count, several slices plus a
    ragged one, and a chunk of many slices a block plus a ragged one; K8b
    over 2 to 8 ranks on each of its routes, the rest on the plan's."""
    cases = [(n * 100,), (n * 4097,), (n * (3 * SLICE_BYTES // 4 + 20),),
             (n * (5 * SLICE_BYTES + 12),), (n * 300007,)]
    if kind == "reduce_scatter" and 2 <= n <= 8:
        return [(shape, route) for shape in cases for route in
                ("memory", "cluster")]
    return [(shape, None) for shape in cases]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _SLICED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_sliced_kernels_match_plain_across_slice_boundaries(
        cuda_device, kind, dtype, n):
    cuda_fn, plain_fn = _RING_KERNELS[kind]
    for shape, route in _slice_cases(kind, n):
        if kind in ("all_gather", "bidir"):
            shape = (shape[0] // n,)
        xs = _ring_shards(n, shape, dtype, cuda_device, seed=n + shape[0])
        counter = (f"{_COUNTERS[kind]}_"
                   f"{route or ('copy' if n == 1 else 'memory')}")
        before = kernels.launch_counts[counter]
        with (forced_route(route) if route else contextlib.nullcontext()):
            got = cuda_fn(xs)
        _assert_ring_bitwise(got, plain_fn(xs))
        assert kernels.launch_counts[counter] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _SLICED)
@pytest.mark.parametrize("cluster", [False, True])
def test_ring_sliced_planted_fault_raises_in_time(cuda_device, kind,
                                                  cluster):
    """A planted fault (rank 0's first hop to right + 1) stops the launch
    within its bounded wait and raises; the next call is right (K8b on
    both its routes)."""
    import time

    cuda_fn, plain_fn = _RING_KERNELS[kind]
    route = (("cluster" if cluster else "memory")
             if kind == "reduce_scatter" else None)
    xs = _ring_shards(4, (4 << 16,), torch.float32, cuda_device)
    want = plain_fn(xs)
    torch.cuda.synchronize()
    with (forced_route(route) if route else contextlib.nullcontext()):
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="bounded wait ran out"):
            cuda_fn(xs, fault=1, timeout_s=0.05)
        assert time.perf_counter() - t0 < 2.0
        _assert_ring_bitwise(cuda_fn(xs), want)


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
