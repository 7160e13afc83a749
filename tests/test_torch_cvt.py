"""The port's CvT layers (``param_tpu_torch.ops.cvt_convs``) against the JAX
package's (``param_tpu.ops.cvt_convs``) on the CPU, parameters carried over
(``models/convert.cvt_params_from_jax``) and inputs from the same numpy
draws.  Tolerance: rtol 1e-5, atol 1e-5 of the largest |value| (outputs and
gradients; convolution sums in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.ops import cvt_convs as J
from param_tpu_torch.cli import cvt as cli
from param_tpu_torch.models.convert import cvt_params_from_jax
from param_tpu_torch.ops import cvt_convs as T


def _close(got, want):
    g = got.detach().float().numpy()
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(w))))


LAYERS = [
    ("conv_proj", dict(kernel_size=3, padding=1, stride=1, method="dw_bn"),
     (2, 10, 10, 8)),
    ("conv_proj", dict(kernel_size=3, padding=1, stride=2, method="dw_bn"),
     (2, 9, 11, 8)),
    ("conv_proj", dict(kernel_size=3, padding=1, stride=2, method="avg"),
     (2, 10, 7, 4)),
    ("conv_proj", dict(kernel_size=2, padding=0, stride=2, method="avg"),
     (1, 5, 5, 3)),
    ("patch_embed", dict(patch_size=7, stride=4, padding=2), (2, 32, 32, 3)),
    ("patch_embed", dict(patch_size=3, stride=2, padding=1), (2, 14, 14, 16)),
]


def _layer(kind, kw, shape, seed=0):
    """(jax fn, port fn, jax params, port params, x numpy, g numpy)."""
    n, h, w, c = shape
    key = jax.random.PRNGKey(seed)
    if kind == "conv_proj":
        jp = J.init_conv_projection(key, c, kw["kernel_size"], kw["method"])
        jf = lambda p, x: J.conv_projection(p, x, **kw)  # noqa: E731
        tf = lambda p, x: T.conv_projection(p, x, **kw)  # noqa: E731
    else:
        e = 24
        jp = J.init_patch_embed(key, c, e, kw["patch_size"])
        sp = dict(stride=kw["stride"], padding=kw["padding"])
        jf = lambda p, x: J.patch_embed(p, x, **sp)  # noqa: E731
        tf = lambda p, x: T.patch_embed(p, x, **sp)  # noqa: E731
    tp = cvt_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(np.shape(jf(jp, jnp.asarray(x)))).astype(np.float32)
    return jf, tf, jp, tp, x, g


@pytest.mark.parametrize("kind,kw,shape", LAYERS,
                         ids=[f"{k}-{kw.get('method', 'conv')}-{s}"
                              for k, kw, s in LAYERS])
def test_layer_forward_matches_jax(kind, kw, shape):
    jf, tf, jp, tp, x, _ = _layer(kind, kw, shape)
    _close(tf(tp, torch.from_numpy(x)), jf(jp, jnp.asarray(x)))


@pytest.mark.parametrize("kind,kw,shape", LAYERS,
                         ids=[f"{k}-{kw.get('method', 'conv')}-{s}"
                              for k, kw, s in LAYERS])
def test_layer_gradients_match_jax(kind, kw, shape):
    """Gradients of sum(y * g) with respect to the parameters and x."""
    jf, tf, jp, tp, x, g = _layer(kind, kw, shape)

    def loss(p, xx):
        return jnp.sum(jf(p, xx) * jnp.asarray(g))

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    keys = sorted(tp)
    grads = torch.autograd.grad((tf(tp, xt) * torch.from_numpy(g)).sum(),
                                [tp[k] for k in keys] + [xt])
    _close(grads[-1], jgx)
    for k, gr in zip(keys, grads):
        want = np.asarray(jgp[k])
        if k == "w":  # HWIO -> OIHW
            want = want.transpose(3, 2, 0, 1)
        _close(gr, want)


@pytest.mark.parametrize("h,w,k,s,p", [
    (10, 10, 3, 2, 1), (9, 7, 3, 2, 1), (5, 5, 2, 2, 1), (6, 6, 3, 3, 0),
    (7, 8, 4, 3, 2), (1, 1, 3, 2, 1)])
def test_ceil_mode_avg_pool_shapes_match_jax(h, w, k, s, p):
    """Ceil-mode output sizes and divisors (count_include_pad); (5, 5, 2, 2,
    1) keeps a last window that starts in the right padding, as the JAX
    package does."""
    x = np.random.default_rng(1).standard_normal((2, h, w, 3)).astype(
        np.float32)
    want = J.avg_pool(jnp.asarray(x), k, s, p)
    got = T.avg_pool(torch.from_numpy(x), k, s, p)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_configs_and_reference_flops_equal_jax():
    assert len(T.CVT_CONFIGS) == len(J.CVT_CONFIGS) == 11
    for t, j in zip(T.CVT_CONFIGS, J.CVT_CONFIGS):
        assert (t.name, t.layer_type, tuple(t.input_shape), t.kwargs) == \
            (j.name, j.layer_type, tuple(j.input_shape), j.kwargs)
        assert T.reference_flops(t) == J.reference_flops(j)


@pytest.mark.parametrize("make", [
    lambda: T.layer_inputs(T.CVT_CONFIGS[0], 0)[2].device,
    lambda: T.init_conv_projection(torch.Generator().manual_seed(0), 4,
                                   3)["w"].device,
    lambda: T.init_patch_embed(torch.Generator().manual_seed(0), 3, 8,
                               7)["w"].device,
], ids=["layer_inputs", "init_conv_projection", "init_patch_embed"])
def test_defaults_are_the_card(make):
    """Named no device, the layers are made on the card; without one the
    call refuses (``resolve_device``) instead of running on the host."""
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_layer_inputs_are_the_jax_draws():
    """``bench_cvt``'s x and g are the JAX package's numpy draws."""
    cfg = T.CvtLayerCfg("tiny", "conv_proj", (2, 4, 6, 6),
                        dict(dim_in=4, dim_out=4, kernel_size=3, padding=1,
                             stride=2, method="dw_bn"))
    _, fn, x, g = T.layer_inputs(cfg, 3, device="cpu")
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(x.numpy(),
                                  rng.random((2, 6, 6, 4), dtype=np.float32))
    np.testing.assert_array_equal(g.numpy(),
                                  rng.random((2, 9, 4), dtype=np.float32))


@pytest.mark.parametrize("forward_only", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bench_cvt_on_cpu(forward_only, dtype, capsys):
    cfgs = [T.CvtLayerCfg("tiny.conv_proj_k", "conv_proj", (2, 8, 10, 10),
                          dict(dim_in=8, dim_out=8, kernel_size=3, padding=1,
                               stride=2, method="dw_bn")),
            T.CvtLayerCfg("tiny.patch_embed", "patch_embed", (2, 3, 16, 16),
                          dict(patch_size=7, in_chans=3, embed_dim=8,
                               stride=4, padding=2))]
    res = T.bench_cvt(cfgs, forward_only=forward_only, dtype=dtype, steps=2,
                      reps=1, device="cpu")
    jkeys = {"name", "layer_type", "input_shape", "elap_s", "ref_flops",
             "tflops", "ref_tfs"}
    assert [r["name"] for r in res] == [c.name for c in cfgs]
    for r in res:
        assert set(r) == jkeys
        assert np.isfinite(r["elap_s"]) and r["elap_s"] > 0
    T.report(res)
    out = capsys.readouterr().out
    assert out.count("CVT-RES tiny.") == 2


def test_cli_layer_filter_on_cpu(capsys):
    assert cli.main(["--layer", "stage2.blocks0.conv_proj_k", "--forward-only",
                     "--steps", "1", "--reps", "1", "--device", "cpu"]) == 0
    rows = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("CVT-RES cvt.")]
    assert len(rows) == 1 and "32x384x14x14" in rows[0]
    assert cli.main(["--layer", "no-such-layer", "--device", "cpu"]) == 1


def test_cli_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--layer", "stage2.blocks0.conv_proj_k", "--forward-only"])
