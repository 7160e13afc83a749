"""The port's transformer block (``param_tpu_torch/models/transformer.py``)
against the reference's on the CPU, on the same parameters (the reference's
``init_params`` converted with ``transformer_params_from_jax``) and the same
inputs (numpy, seeded).

The reference's flash attention runs its Pallas kernel in interpret mode.
Tolerances: f32 blocks 2e-5 (the reference's own serving tests use 2e-5 to
3e-5; sums in another order); bf16 blocks 2e-2 of max|out| (bf16 rounding
at different places of LN, gelu and the matmuls); weight-only int8 / int4
steps in an f32 model 2e-5 (the same exact integer products and f32 sums,
x rounded to bf16 on both sides); quantized weights and the nibble packing
exactly.  Training (two SGD steps at lr 0.1 in f32 and 1.0 in bf16,
where the update then moves most weights by one or more ulps): f32 losses
1e-6 and params 2e-5, gradients 1e-4 of the largest (sums in another
order); bf16 losses 2e-3 relative, gradients 2e-2 of the largest (bf16
rounding at other places of the forward and backward), every param within
two bf16 ulps of the larger of the two values (each step's rounding of the
update may flip) plus 2e-2 of that parameter's largest update (the
gradients' tolerance carried through).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import param_tpu.models.transformer as jt
import param_tpu_torch.models.transformer as tt
from param_tpu_torch.models.convert import transformer_params_from_jax
from param_tpu_torch.ops.matmul import pack_nibbles


def _cfgs(**kw):
    base = dict(batch=2, seq=64, emb=128, heads=2, ffn=256, dtype="float32",
                attention="xla")
    base.update(kw)
    return jt.TransformerConfig(**base), tt.TransformerConfig(**base)


def _params(jcfg, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    np_p = jax.tree.map(np.asarray, jp)
    return jp, transformer_params_from_jax(np_p, "cpu")


def _x(cfg, seed=1, seq=None):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((cfg.batch, seq or cfg.seq, cfg.emb),
                            dtype=np.float32) * 0.1
    jdt = jnp.dtype(cfg.dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_params_convert_bit_for_bit():
    jcfg, tcfg = _cfgs(dtype="bfloat16", kv_heads=1)
    jp, tp = _params(jcfg)
    assert set(tp) == set(jp)
    for key in ("wqkv", "wo", "w1", "w2"):
        assert tp[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[key].view(torch.int16).numpy(),
            np.asarray(jp[key]).view(np.int16))
    assert tp["wqkv"].shape == (128, 128 + 2 * 64)  # kv heads 1 of 64
    assert isinstance(tp["ln1"], tuple) and tp["ln1"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("attention", ["flash", "xla"])
@pytest.mark.parametrize("kv_heads", [None, 1])
def test_block_apply_matches_reference(attention, kv_heads):
    jcfg, tcfg = _cfgs(attention=attention, kv_heads=kv_heads)
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg)
    _close(tt.block_apply(tp, tx, tcfg), jt.block_apply(jp, jx, jcfg), 2e-5)


def test_block_apply_bf16_matches_reference():
    jcfg, tcfg = _cfgs(attention="flash", dtype="bfloat16")
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg)
    want = np.asarray(jt.block_apply(jp, jx, jcfg), np.float32)
    got = tt.block_apply(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_flash_block_matches_xla_block():
    """The port's two attention paths give the same block (as the
    reference pins for its own)."""
    _, tcfg_f = _cfgs(attention="flash", causal=True)
    jcfg, tcfg_x = _cfgs(attention="xla", causal=True)
    _, tp = _params(jcfg)
    _, tx = _x(jcfg)
    torch.testing.assert_close(tt.block_apply(tp, tx, tcfg_f),
                               tt.block_apply(tp, tx, tcfg_x),
                               atol=2e-5, rtol=2e-5)


def test_ln_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32) * 2 + 0.5
    g = rng.standard_normal(64, dtype=np.float32)
    b = rng.standard_normal(64, dtype=np.float32)
    want = jt._ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tt._ln(*(torch.from_numpy(a) for a in (x, g, b)))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("attention", ["flash", "xla"])
@pytest.mark.parametrize("kv_heads,window", [(None, None), (2, None),
                                             (None, 8)])
def test_prefill_and_decode_match_reference(attention, kv_heads, window):
    """Prefill 24 tokens, then decode the rest token by token; every
    step's output and the final cache against the reference's."""
    t0, n = 24, 32
    jcfg, tcfg = _cfgs(batch=2, seq=1, emb=128, heads=4, kv_heads=kv_heads)
    jpre, tpre = _cfgs(batch=2, seq=t0, emb=128, heads=4, kv_heads=kv_heads,
                       attention=attention)
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg, seq=n)
    jout, jcache = jt.prefill(jp, jx[:, :t0], jpre, n)
    tout, tcache = tt.prefill(tp, tx[:, :t0], tpre, n)
    _close(tout, jout, 2e-5)
    assert tcache["k"].shape == (2, tcfg.kvh, n, 32)
    for t in range(t0, n):
        jout, jcache = jt.decode_step(jp, jcache, jx[:, t:t + 1], t, jcfg,
                                      window=window)
        tout, tcache = tt.decode_step(tp, tcache, tx[:, t:t + 1], t, tcfg,
                                      window=window)
        _close(tout, jout, 3e-5)
    _close(tcache["k"], jcache["k"], 2e-5)
    _close(tcache["v"], jcache["v"], 2e-5)


def test_quantized_weights_equal_reference():
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    j8, t8 = jt.quantize_block_weights_int8(jp), \
        tt.quantize_block_weights_int8(tp)
    j4, t4 = jt.quantize_block_weights_int4(jp, group=64), \
        tt.quantize_block_weights_int4(tp, group=64)
    for key in tt.MATMUL_WEIGHTS:
        for a, b in zip(t8[key], j8[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        (q, s, g), (jq, js, jg) = t4[key], j4[key]
        assert g == jg == 64 and q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert t8["ln1"] is tp["ln1"]


def test_cast_int4_params_packs_the_carriers_exactly():
    jcfg, _ = _cfgs()
    _, tp = _params(jcfg)
    q4 = tt.quantize_block_weights_int4(tp, group=32)
    packed = tt.cast_int4_params(q4)
    for key in tt.MATMUL_WEIGHTS:
        q, s, g = q4[key]
        p, s2, g2 = packed[key]
        assert p.shape == (q.shape[0] // 2, q.shape[1]) and p.dtype == torch.int8
        assert s2 is s and g2 == g
        qn, pn = q.numpy().astype(np.int32), p.numpy().astype(np.int32)
        np.testing.assert_array_equal((pn & 15) - 8, qn[0::2])
        np.testing.assert_array_equal(pn >> 4, qn[1::2])
    torch.testing.assert_close(packed["wo"][0], pack_nibbles(q4["wo"][0]),
                               rtol=0, atol=0)
    assert packed["ln2"] is tp["ln2"]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_mm_matches_reference(bits):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((256, 192), dtype=np.float32) * 0.05
    x = rng.standard_normal((3, 1, 256), dtype=np.float32) * 0.1
    wts = {k: jnp.asarray(w) for k in tt.MATMUL_WEIGHTS}
    jq = (jt.quantize_block_weights_int8(wts) if bits == 8
          else jt.quantize_block_weights_int4(wts, group=64))["wqkv"]
    tq = transformer_params_from_jax(
        {"w": jax.tree.map(np.asarray, jq)}, "cpu")["w"]
    want = jt._mm(jnp.asarray(x), jq)
    if bits == 4:  # K5 takes the nibble-packed (serving) layout only
        with pytest.raises(ValueError, match="cast_int4_params"):
            tt._mm(torch.from_numpy(x), tq)
        tq = tt.cast_int4_params({"w": tq})["w"]
    got = tt._mm(torch.from_numpy(x), tq)
    assert got.shape == (3, 1, 192) and got.dtype == torch.float32
    _close(got, want, 2e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_quantized_decode_step_matches_reference(bits, kv_heads):
    jcfg, tcfg = _cfgs(batch=2, seq=1, emb=128, heads=4, kv_heads=kv_heads)
    jpre, tpre = _cfgs(batch=2, seq=24, emb=128, heads=4, kv_heads=kv_heads)
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg, seq=26)
    _, jcache = jt.prefill(jp, jx[:, :24], jpre, 32)
    _, tcache = tt.prefill(tp, tx[:, :24], tpre, 32)
    if bits == 8:
        jq, tq = jt.quantize_block_weights_int8(jp), \
            tt.quantize_block_weights_int8(tp)
    else:
        jq = jt.quantize_block_weights_int4(jp, group=64)
        tq = tt.cast_int4_params(tt.quantize_block_weights_int4(tp, group=64))
    for t in (24, 25):
        jout, jcache = jt.decode_step(jq, jcache, jx[:, t:t + 1], t, jcfg)
        tout, tcache = tt.decode_step(tq, tcache, tx[:, t:t + 1], t, tcfg)
        _close(tout, jout, 2e-5)


DECODE_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                              "decode_attention_bf16.npz")


def _decode_case():
    """bf16 q (1, 2, 4, 64) (GQA: 4 query heads per kv head), k / v
    (1, 2, 128, 64) and cache positions 0..100 valid, from seed 0."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .bfloat16() for s in ((1, 2, 4, 64), (1, 2, 128, 64),
                                     (1, 2, 128, 64)))
    return q, k, v, np.arange(128) <= 100


def _reference_decode_attention(q, k, v, valid):
    """``param_tpu/models/transformer.py:336-346``, the reference's decode
    attention in the cache's dtype with f32 accumulation (its query axis
    of one dropped), before the output's cast to x's dtype."""
    q, k, v = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in (q, k, v))
    logits = jnp.einsum("bkgd,bksd->bkgs", q, k,
                        preferred_element_type=jnp.float32) / 8.0
    logits = jnp.where(valid, logits, -1e30)
    p = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return np.asarray(jnp.einsum("bkgs,bksd->bkgd", p, v,
                                 preferred_element_type=jnp.float32))


def test_decode_attention_fixture_is_the_reference():
    """``tests/fixtures/decode_attention_bf16.npz`` holds ``_decode_case``'s
    inputs (bf16 bits) and the reference's output on them, so that the
    card's decode attention (``test_torch_kernels.py``, where JAX is not
    installed) is held against the reference.  Here: the stored inputs are
    this case's, the stored output is the reference's (sums in XLA's order:
    rtol 1e-5), and the port's CPU decode attention agrees with it within
    the card test's tolerance.  Remake it with ``np.savez_compressed`` of
    q, k, v (``.view(torch.int16)``), valid and out."""
    from param_tpu_torch.ops.attention import decode_attention

    q, k, v, valid = _decode_case()
    f = np.load(DECODE_FIXTURE)
    for name, t in (("q", q), ("k", k), ("v", v)):
        np.testing.assert_array_equal(f[name], t.view(torch.int16).numpy())
    np.testing.assert_array_equal(f["valid"], valid)
    np.testing.assert_allclose(f["out"],
                               _reference_decode_attention(q, k, v, valid),
                               rtol=1e-5, atol=1e-7)
    got = decode_attention(q, k, v, torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), f["out"], rtol=1e-3, atol=1e-4)


def test_config_rejects_bad_heads():
    with pytest.raises(ValueError, match="kv heads"):
        tt.TransformerConfig(batch=1, seq=8, emb=64, heads=4, ffn=8,
                             kv_heads=3).kvh
    with pytest.raises(ValueError, match="heads"):
        tt.TransformerConfig(batch=1, seq=8, emb=66, heads=4, ffn=8).head_dim


def test_init_params_shapes_and_generator():
    cfg = tt.TransformerConfig(batch=1, seq=8, emb=64, heads=4, ffn=96,
                               kv_heads=2, dtype="bfloat16")
    p1 = tt.init_params(torch.Generator().manual_seed(7), cfg, "cpu")
    p2 = tt.init_params(torch.Generator().manual_seed(7), cfg, "cpu")
    assert p1["wqkv"].shape == (64, 64 + 2 * 2 * 16)
    assert p1["w1"].shape == (64, 96) and p1["w2"].shape == (96, 64)
    assert all(p1[k].dtype == torch.bfloat16 for k in tt.MATMUL_WEIGHTS)
    torch.testing.assert_close(p1["w2"], p2["w2"], rtol=0, atol=0)


# ------------------------------------------------------------- training
def _train_cfgs(**kw):
    base = dict(batch=2, seq=128, emb=256, heads=4, ffn=512)
    base.update(kw)
    return _cfgs(**base)


def _bf16_ulp(x):
    """One bf16 ulp of each |x| (2^-133 at zero)."""
    x = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_train_step_matches_reference(dtype, attention):
    """Two steps of make_train_step from the same weights: the losses and
    every parameter after them against the reference's."""
    jcfg, tcfg = _train_cfgs(dtype=dtype, attention=attention)
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg)
    lr = 0.1 if dtype == "float32" else 1.0
    jstep, tstep = jt.make_train_step(jcfg, lr=lr), \
        tt.make_train_step(tcfg, lr=lr)
    tp0 = [t.clone() for t in tt.leaves(tp)]
    jp0 = tt.leaves(jp)
    for _ in range(2):
        jp, jloss = jstep(jp, jx)
        tp_new, tloss = tstep(tp, tx)
        assert tloss.dtype == torch.float32 and tloss.dim() == 0
        if dtype == "float32":
            assert abs(tloss.item() - float(jloss)) <= 1e-6
        else:
            assert abs(tloss.item() - float(jloss)) <= 2e-3 * float(jloss)
        tp = tp_new
    moved = 0
    for got, want, before, jbefore in zip(tt.leaves(tp), tt.leaves(jp), tp0,
                                          jp0):
        want = np.asarray(want, np.float32)
        assert got.dtype == before.dtype
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        else:
            update = np.abs(want - np.asarray(jbefore, np.float32)).max()
            tol = 2 * _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + \
                2e-2 * update
            assert (np.abs(got - want) <= tol).all()
        moved += int((got != before.float().numpy()).sum())
    assert moved > 0.5 * sum(t.numel() for t in tp0[4:])  # updates resolved


@pytest.mark.parametrize("dtype,attention,heads", [
    ("float32", "flash", 4), ("float32", "xla", 2), ("bfloat16", "flash", 2)])
def test_grads_match_jax_grad(dtype, attention, heads):
    """The gradient of every parameter (LN pairs included) of the loss
    mean(out^2), against jax.grad of the reference's."""
    jcfg, tcfg = _train_cfgs(dtype=dtype, attention=attention, heads=heads)
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg)
    jloss, jg = jax.value_and_grad(lambda p: jnp.mean(jnp.square(
        jt.block_apply(p, jx, jcfg).astype(jnp.float32))))(jp)
    tloss, tg = tt.value_and_grad(tp, tx, tcfg)
    assert set(tg) == set(tp) and isinstance(tg["ln1"], tuple)
    rel = 1e-4 if dtype == "float32" else 2e-2
    for got, want in zip(tt.leaves(tg), tt.leaves(jg)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= rel * np.abs(want).max(), err


def test_gqa_flash_train_matches_reference_xla():
    """GQA through the port's flash path (K7's plain version sums dk / dv
    over each query group) against the reference's unfused path, whose
    jax.grad takes GQA: gradients and one step."""
    jcfg, _ = _train_cfgs(attention="xla", kv_heads=2)
    _, tcfg = _train_cfgs(attention="flash", kv_heads=2)
    jp, tp = _params(jcfg)
    jx, tx = _x(jcfg)
    jloss, jg = jax.value_and_grad(lambda p: jnp.mean(jnp.square(
        jt.block_apply(p, jx, jcfg))))(jp)
    tloss, tg = tt.value_and_grad(tp, tx, tcfg)
    assert abs(tloss.item() - float(jloss)) <= 1e-6
    for got, want in zip(tt.leaves(tg), tt.leaves(jg)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    jp2, _ = jt.make_train_step(jcfg, lr=0.1)(jp, jx)
    tp2, _ = tt.make_train_step(tcfg, lr=0.1)(tp, tx)
    for got, want in zip(tt.leaves(tp2), tt.leaves(jp2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_train_loss_decreases_and_params_are_not_updated_in_place():
    jcfg, tcfg = _train_cfgs(attention="flash", seq=64)
    _, tp = _params(jcfg)
    _, tx = _x(jcfg)
    before = [t.clone() for t in tt.leaves(tp)]
    step = tt.make_train_step(tcfg, lr=0.1)
    losses, p = [], tp
    for _ in range(4):
        p, loss = step(p, tx)
        losses.append(loss.item())
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    for t, b in zip(tt.leaves(tp), before):
        assert torch.equal(t, b)


def test_leaves_pair_converted_params_with_the_reference():
    """leaves() walks the port's params and the reference's in one order,
    so the training tests compare like with like; _rebuild inverts it."""
    jcfg, _ = _cfgs(kv_heads=1)
    jp, tp = _params(jcfg)
    got, want = tt.leaves(tp), tt.leaves(jp)
    assert len(got) == len(want) == 8  # two LN pairs and four matrices
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tt._rebuild(tp, got)
    assert isinstance(back["ln1"], tuple) and back.keys() == tp.keys()
    assert all(a is b for a, b in zip(tt.leaves(back), got))
