"""The port's attention (``param_tpu_torch/ops/attention.py``) against the
reference's on the CPU.

Inputs are numpy arrays from a seeded generator, handed to both packages
(bf16 inputs round to the same bits in both).  The reference's Pallas flash
kernel runs in interpret mode, as ``tests/test_attention.py`` runs it; the
port's ``flash_attention`` runs K6's plain version on CPU tensors.
Tolerances are those of ``tests/test_attention.py``: f32 2e-5 (sums in
another order), bf16 2e-2 (the reference rounds P to bf16 before the PV
product, and in the backward P and dS before their products, the port's
plain versions do not: at most about two bf16 ulps of the largest
gradients); lse 1e-5 (f32 throughout).  The backward's oracle is the
reference's Pallas backward where it runs, and ``jax.grad`` of its
``mha_reference`` for GQA, which its Pallas backward cannot take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import param_tpu.ops.attention as ja
from param_tpu_torch.ops import attention as ta

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(shapes, dtype="float32", seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32) * scale for s in shapes]
    jdt, tdt = _DT[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference_kernel(causal, dtype):
    shape = (1, 2, 256, 128)
    (jq, jk, jv), (tq, tk, tv) = _inputs([shape] * 3, dtype, seed=1)
    want = ja.flash_attention(jq, jk, jv, causal=causal, block_q=128,
                              block_k=128)
    got = ta.flash_attention(tq, tk, tv, causal=causal, block_q=128,
                             block_k=128)
    assert got.dtype == tq.dtype and got.shape == shape
    _close(got, want, _TOL[dtype])


@pytest.mark.parametrize("sq", [64, 128])
def test_flash_rectangular_causal(sq):
    """S_q < S_k: the diagonal sits bottom-right."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(1, 2, sq, 128), (1, 2, 256, 128), (1, 2, 256, 128)], seed=sq)
    want = ja.flash_attention(jq, jk, jv, causal=True, block_q=64,
                              block_k=128)
    got = ta.flash_attention(tq, tk, tv, causal=True, block_q=64,
                             block_k=128)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("h_kv,causal", [(2, True), (2, False), (1, True)])
def test_flash_gqa(h_kv, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(1, 4, 128, 64), (1, h_kv, 128, 64), (1, h_kv, 128, 64)], seed=3,
        scale=0.3)
    want = ja.flash_attention(jq, jk, jv, causal=causal, block_q=128,
                              block_k=128)
    got = ta.flash_attention(tq, tk, tv, causal=causal, block_q=128,
                             block_k=128)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("w,d", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_flash_sliding_window(w, d):
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 2, 256, d)] * 3, seed=w + d,
                                         scale=0.3)
    want = ja.flash_attention(jq, jk, jv, causal=True, window=w, block_q=64,
                              block_k=64)
    got = ta.flash_attention(tq, tk, tv, causal=True, window=w, block_q=64,
                             block_k=64)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("causal,d", [(False, 64), (True, 64), (True, 128)])
def test_flash_lse_matches_reference(causal, d):
    b, h, s = 1, 2, 128
    (jq, jk, jv), (tq, tk, tv) = _inputs([(b, h, s, d)] * 3, seed=d)
    jo, jlse = ja._flash_forward(jq, jk, jv, causal=causal, scale=None,
                                 block_q=128, block_k=128, interpret=None,
                                 return_lse=True, pack_heads=False)
    to, tlse = ta._flash_forward(tq, tk, tv, causal=causal, scale=None,
                                 block_q=128, block_k=128, return_lse=True)
    _close(to, jo, 2e-5)
    assert tlse.shape == (b, h, s) and tlse.dtype == torch.float32
    _close(tlse, np.asarray(jlse)[..., 0].reshape(b, h, s), 1e-5)


@pytest.mark.parametrize("causal,window,h_kv,sq", [
    (False, None, 4, 96), (True, None, 4, 96), (True, None, 2, 40),
    (True, 16, 1, 96), (False, 16, 4, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_matches(causal, window, h_kv, sq, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, 4, sq, 32), (2, h_kv, 96, 32), (2, h_kv, 96, 32)], dtype,
        seed=sq + h_kv)
    want = ja.mha_reference(jq, jk, jv, causal=causal, window=window)
    got = ta.mha_reference(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    # bf16: both round P to bf16 and O once; 1e-2 covers an ulp of either
    _close(got, want, 2e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("kwargs,shapes,exc,match", [
    (dict(block_q=96), [(1, 2, 256, 64)] * 3, ValueError, "divide blocks"),
    ({}, [(1, 6, 128, 64), (1, 4, 128, 64), (1, 4, 128, 64)], ValueError,
     "kv heads"),
    (dict(causal=True), [(1, 2, 256, 64), (1, 2, 128, 64), (1, 2, 128, 64)],
     NotImplementedError, "S_q <= S_k"),
    (dict(window=32), [(1, 2, 128, 64)] * 3, NotImplementedError, "causal"),
])
def test_flash_raises_like_reference(kwargs, shapes, exc, match):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shapes)
    with pytest.raises(exc, match=match):
        ja.flash_attention(jq, jk, jv, **kwargs)
    with pytest.raises(exc, match=match):
        ta.flash_attention(tq, tk, tv, **kwargs)


def test_window_with_lse_raises_like_reference():
    (jq, _, _), (tq, _, _) = _inputs([(1, 2, 128, 64)] * 3)
    with pytest.raises(NotImplementedError, match="forward/serving"):
        ja._flash_forward(jq, jq, jq, causal=True, scale=None, block_q=128,
                          block_k=128, interpret=None, return_lse=True,
                          window=16)
    with pytest.raises(NotImplementedError, match="forward/serving"):
        ta._flash_forward(tq, tq, tq, causal=True, scale=None, block_q=128,
                          block_k=128, return_lse=True, window=16)


@pytest.mark.parametrize("shape", [(1, 32, 2048, 2048, 128),
                                   (8, 12, 1024, 1024, 64),
                                   (1, 32, 128, 2048, 128),
                                   (2, 3, 256, 100, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_flops_and_bytes_equal_reference(shape, causal):
    assert ta.attention_flops(*shape, causal) == ja.attention_flops(*shape,
                                                                    causal)
    assert ta.attention_bytes(*shape, 2) == ja.attention_bytes(*shape, 2)
    if shape[:4] == (1, 32, 2048, 2048) and causal:
        assert ta.attention_flops(*shape, causal) == 34359738368  # 3.44e10


def test_flash_mha_forward_and_fallback():
    """flash_mha takes the flash path where the reference's kernel tiles
    and the unfused path elsewhere (causal S_q > S_k), as the reference."""
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 2, 128, 64)] * 3, seed=9)
    _close(ta.flash_mha(tq, tk, tv, True), ja.flash_mha(jq, jk, jv, True),
           2e-5)
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(1, 2, 64, 32), (1, 2, 32, 32), (1, 2, 32, 32)], seed=10)
    got = ta.flash_mha(tq, tk, tv, True)
    _close(got, ja.flash_mha(jq, jk, jv, True), 2e-5)
    _close(got, ja.mha_reference(jq, jk, jv, causal=True), 2e-5)


@pytest.mark.parametrize("causal,sq,sk,bq", [
    (True, 256, 256, 128),    # the reference's compacted lower-triangle walk
    (False, 256, 256, 128),   # its rectangular dq / dkv grids
    (True, 128, 256, 128),    # S_q < S_k, diagonal bottom-right
    (True, 256, 256, 256),    # a single causal tile
])
def test_flash_attention_bwd_matches_reference_kernel(causal, sq, sk, bq):
    """K7's plain version against the reference's Pallas dq / dkv kernels
    (interpret mode), each from its own forward's (o, lse)."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(
        [(1, 2, sq, 128), (1, 2, sk, 128), (1, 2, sk, 128), (1, 2, sq, 128)],
        seed=20)
    jo, jlse = ja._flash_forward(jq, jk, jv, causal=causal, scale=None,
                                 block_q=bq, block_k=bq, interpret=None,
                                 return_lse=True, pack_heads=False)
    want = ja.flash_attention_bwd(jq, jk, jv, jo, jlse, jg, causal=causal,
                                  block_q=bq, block_k=bq)
    to, tlse = ta._flash_forward(tq, tk, tv, causal=causal, scale=None,
                                 block_q=bq, block_k=bq, return_lse=True)
    got = ta.flash_attention_bwd(tq, tk, tv, to, tlse, tg, causal=causal,
                                 block_q=bq, block_k=bq)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, 2e-5)


def test_flash_attention_bwd_raises_like_reference():
    (jq, jg), (tq, tg) = _inputs([(1, 2, 256, 64), (1, 2, 256, 64)])
    jlse = jnp.zeros((2, 256, 128), jnp.float32)
    with pytest.raises(ValueError, match="divide blocks"):
        ja.flash_attention_bwd(jq, jq, jq, jq, jlse, jg, block_q=96)
    with pytest.raises(ValueError, match="divide blocks"):
        ta.flash_attention_bwd(tq, tq, tq, tq, torch.zeros((1, 2, 256)), tg,
                               block_q=96)


def _grads(fn, q, k, v, g):
    """Gradients of q, k, v of sum(fn(q, k, v) * g) under autograd."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad((fn(*leaves).float() * g.float()).sum(),
                               leaves)


def _jax_grads(fn, q, k, v, g):
    return jax.grad(lambda q, k, v: jnp.sum(
        fn(q, k, v).astype(jnp.float32) * g.astype(jnp.float32)),
        argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("dtype,d,causal", [
    ("float32", 64, True), ("float32", 128, False), ("bfloat16", 64, True),
    ("bfloat16", 128, True)])
def test_flash_mha_grads_match_reference(dtype, d, causal):
    """flash_mha's gradients (K6 and K7's plain versions) against
    ``jax.grad`` of the reference's flash_mha (its Pallas kernels in both
    directions)."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs([(1, 2, 128, d)] * 4, dtype,
                                                 seed=d)
    want = _jax_grads(lambda q, k, v: ja.flash_mha(q, k, v, causal),
                      jq, jk, jv, jg)
    got = _grads(lambda q, k, v: ta.flash_mha(q, k, v, causal), tq, tk, tv,
                 tg)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        _close(g, w, _TOL[dtype])


@pytest.mark.parametrize("h,h_kv", [(8, 2), (4, 1)])
def test_flash_mha_gqa_grads_match_mha_reference_grad(h, h_kv):
    """GQA: the reference's Pallas backward reshapes K / V to B*H heads and
    fails, so the oracle is ``jax.grad`` of its mha_reference; dk and dv
    sum over each kv head's query group."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(
        [(1, h, 128, 64), (1, h_kv, 128, 64), (1, h_kv, 128, 64),
         (1, h, 128, 64)], seed=h)
    want = _jax_grads(lambda q, k, v: ja.mha_reference(q, k, v, causal=True),
                      jq, jk, jv, jg)
    got = _grads(lambda q, k, v: ta.flash_mha(q, k, v, True), tq, tk, tv, tg)
    assert got[1].shape == (1, h_kv, 128, 64)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


def test_flash_mha_fallback_grads_match_reference():
    """Causal S_q > S_k: both packages fall back to the unfused path, whose
    gradients come from autograd (jax.grad) of plain operations."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(
        [(1, 2, 64, 32), (1, 2, 32, 32), (1, 2, 32, 32), (1, 2, 64, 32)],
        seed=12)
    want = _jax_grads(lambda q, k, v: ja.flash_mha(q, k, v, True),
                      jq, jk, jv, jg)
    got = _grads(lambda q, k, v: ta.flash_mha(q, k, v, True), tq, tk, tv, tg)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


def test_flash_mha_asks_for_the_lse_only_for_a_gradient(monkeypatch):
    """The forward-only paths pay nothing for training: flash_mha requests
    the lse from K6 only when a gradient will be taken."""
    calls = []
    real = ta.flash_fwd

    def spy(*args):
        calls.append(args[-1] if len(args) == 7 else False)
        return real(*args)

    monkeypatch.setattr(ta, "flash_fwd", spy)
    _, (tq, tk, tv) = _inputs([(1, 2, 64, 32)] * 3, seed=11)
    ta.flash_mha(tq, tk, tv, True)
    with torch.no_grad():
        ta.flash_mha(tq.requires_grad_(True), tk, tv, True)
    assert calls == [False, False]
    ta.flash_mha(tq, tk, tv, True).sum().backward()
    assert calls == [False, False, True] and tq.grad is not None


@pytest.mark.parametrize("path", ["xla", "flash", "dpa"])
@pytest.mark.parametrize("causal", [False, True])
def test_make_attention_paths_agree(path, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 2, 128, 64)] * 3, seed=13)
    want = ja.mha_reference(jq, jk, jv, causal=causal)
    _close(ta.make_attention(path, causal=causal)(tq, tk, tv), want, 2e-5)


def test_make_attention_gqa_dpa_and_unknown_paths():
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)], seed=14)
    _close(ta.make_attention("dpa", causal=True)(tq, tk, tv),
           ja.mha_reference(jq, jk, jv, causal=True), 2e-5)
    with pytest.raises(ValueError, match="no counterpart"):
        ta.make_attention("jax-flash")
    with pytest.raises(ValueError, match="unknown"):
        ta.make_attention("cudnn")
