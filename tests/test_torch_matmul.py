"""The port's GEMM ops (K3, K4, K5 through their plain versions on the
CPU) against ``param_tpu.ops.matmul`` (Pallas in interpret mode).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: f32 GEMMs rtol 1e-5 (sums of at most 256 terms in another
order); int4 atol 1e-5 x max|out| (both sides dequantize each weight in f32
and accumulate in f32, in another order); bf16 sums of ones are exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# both packages' ops/__init__ re-export a function named matmul over the
# module's name
tm = importlib.import_module("param_tpu_torch.ops.matmul")
jm = importlib.import_module("param_tpu.ops.matmul")


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_matmul_matches_xla_dot():
    rng = np.random.default_rng(0)
    a, b = _np(rng, (64, 32)), _np(rng, (32, 48))
    want = np.asarray(jm.matmul(jnp.asarray(a), jnp.asarray(b)))
    got = tm.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_matmul_pallas_f32_matches_reference():
    rng = np.random.default_rng(1)
    a, b = _np(rng, (256, 256)), _np(rng, (256, 256))
    blocks = dict(block_m=128, block_n=128, block_k=128)
    want = np.asarray(jm.matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                       **blocks))
    got = tm.matmul_pallas(torch.from_numpy(a), torch.from_numpy(b), **blocks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_matmul_pallas_bf16_ones():
    blocks = dict(block_m=128, block_n=128, block_k=128)
    want = jm.matmul_pallas(jnp.ones((128, 128), jnp.bfloat16),
                            jnp.ones((128, 128), jnp.bfloat16), **blocks)
    got = tm.matmul_pallas(torch.ones((128, 128), dtype=torch.bfloat16),
                           torch.ones((128, 128), dtype=torch.bfloat16),
                           **blocks)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(want, np.float32), 128.0)
    np.testing.assert_array_equal(got.float().numpy(), 128.0)


def test_matmul_pallas_out_dtype():
    rng = np.random.default_rng(2)
    a, b = _np(rng, (64, 128)), _np(rng, (128, 64))
    want = np.asarray(jm.matmul_pallas(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        block_m=64, block_n=64, block_k=128, out_dtype=jnp.float32))
    got = tm.matmul_pallas(torch.from_numpy(a).bfloat16(),
                           torch.from_numpy(b).bfloat16(), block_m=64,
                           block_n=64, block_k=128, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_matmul_pallas_bad_blocks_raise_in_both():
    with pytest.raises(ValueError):
        jm.matmul_pallas(jnp.ones((100, 100)), jnp.ones((100, 100)),
                         block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError):
        tm.matmul_pallas(torch.ones((100, 100)), torch.ones((100, 100)),
                         block_m=64, block_n=64, block_k=64)
    # the default blocks clip to the shape, so a ragged shape passes
    out = tm.matmul_pallas(torch.ones((100, 100)), torch.ones((100, 100)))
    np.testing.assert_array_equal(out.numpy(), 100.0)


def test_gemm_flops():
    for shape in [(2, 3, 4), (128, 4096, 4096), (4096, 40928, 1024)]:
        assert tm.gemm_flops(*shape) == jm.gemm_flops(*shape)


def test_weight_resident_matches_reference():
    rng = np.random.default_rng(3)
    a, b = rng.random((4, 64, 128), dtype=np.float32), \
        rng.random((128, 256), dtype=np.float32)
    want = np.asarray(jm.matmul_weight_resident(jnp.asarray(a),
                                                jnp.asarray(b), block_n=128))
    got = tm.matmul_weight_resident(torch.from_numpy(a), torch.from_numpy(b),
                                    block_n=128)
    assert tuple(got.shape) == (4, 64, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    with pytest.raises(ValueError):
        tm.matmul_weight_resident(torch.from_numpy(a), torch.from_numpy(b),
                                  block_n=96)


@pytest.mark.parametrize("k,n,group", [(512, 256, 128), (256, 128, 64),
                                       (64, 32, 128)])
def test_pack_int4_bytes_and_scales_equal(k, n, group):
    rng = np.random.default_rng(k + n)
    w = _np(rng, (k, n), 0.05)
    w[:, 0] = 0.0  # an all-zero column takes scale 1
    jp, js = jm.pack_int4(jnp.asarray(w), group)
    tp, ts = tm.pack_int4(torch.from_numpy(w), group)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("variant", ["tile-scale", "group-dots"])
def test_matmul_int4_matches_reference(variant):
    rng = np.random.default_rng(4)
    k, n, g = 512, 256, 128
    w, x = _np(rng, (k, n), 0.05), _np(rng, (5, k), 0.1)
    packed, scale = jm.pack_int4(jnp.asarray(w), g)
    want = np.asarray(jm.matmul_int4(jnp.asarray(x), packed, scale,
                                     out_dtype=jnp.float32, variant=variant))
    got = tm.matmul_int4(torch.from_numpy(x),
                         torch.from_numpy(np.array(packed)),
                         torch.from_numpy(np.array(scale)),
                         out_dtype=torch.float32, variant=variant).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _dequant_oracle(packed, scale, g):
    pn = packed.astype(np.int32)
    wd = np.zeros((2 * pn.shape[0], pn.shape[1]), np.float32)
    wd[0::2] = (pn & 15) - 8
    wd[1::2] = np.right_shift(pn, 4)
    return wd * np.repeat(scale, g, axis=0)


@pytest.mark.parametrize("m,k,n", [(3, 1280, 200), (40, 384, 200),
                                   (1, 256, 136)])
def test_matmul_int4_any_n_and_k(m, k, n):
    """N with no 128-multiple and K not a multiple of block_k: the port
    takes them (the reference's automatic block_n raises StopIteration)."""
    rng = np.random.default_rng(m)
    w, x = _np(rng, (k, n), 0.05), _np(rng, (m, k), 0.1)
    packed, scale = tm.pack_int4(torch.from_numpy(w), 128)
    got = tm.matmul_int4(torch.from_numpy(x), packed, scale,
                         out_dtype=torch.float32).numpy()
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    want = xb @ _dequant_oracle(packed.numpy(), scale.numpy(), 128)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        tm.matmul_int4(torch.from_numpy(x), packed, scale, block_n=128)


def test_matmul_int4_variants_and_shapes():
    x = torch.ones((2, 256))
    packed, scale = tm.pack_int4(torch.ones((256, 64)), 128)
    outs = [tm.matmul_int4(x, packed, scale, variant=v)
            for v in tm.INT4_VARIANTS]
    assert all(o.dtype == torch.float32 for o in outs)
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tm.matmul_int4(x, packed, scale, variant="mxu")
    with pytest.raises(ValueError):
        tm.matmul_int4(torch.ones((2, 128)), packed, scale)
