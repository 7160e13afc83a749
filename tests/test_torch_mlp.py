"""The port's MLP train and infer steps against ``param_tpu.ops.mlp``.

Both packages start from the same numpy-made parameters
(``mlp_params_from_jax``; the Adagrad accumulators from optax's initial
state through ``adagrad_state_from_jax``) and inputs, and take three steps.
Tolerances: f32 rtol 1e-5 (and 1e-5 x max |want| absolute, for entries that
cancel to near zero); bf16 two bf16 ulps of max |want| for the parameters
and the outputs, and rtol two bf16 ulps (2^-6) for the losses, since every
layer's output is rounded to bf16 on both sides and a sum taken in another
order may round one ulp apart.  Adagrad's bf16 accumulators sum the
squares of such gradients, a step's two roundings apart, so they are held
to four ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.ops import mlp as jmlp
from param_tpu_torch.models.convert import (
    adagrad_state_from_jax, mlp_params_from_jax,
)
from param_tpu_torch.ops import mlp as tmlp

DIMS = [16, 32, 24, 8]
BATCH = 12
STEPS = 3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np_params(dtype, seed=0):
    """He-scaled weights and small non-zero biases, in ``dtype``, as numpy
    (bf16 as ``ml_dtypes.bfloat16``)."""
    rng = np.random.default_rng(seed)
    out = []
    for din, dout in zip(DIMS[:-1], DIMS[1:]):
        w = rng.standard_normal((din, dout), dtype=np.float32) * (2 / din) ** .5
        b = rng.standard_normal(dout, dtype=np.float32) * 0.1
        out.append(tuple(np.asarray(jnp.asarray(a, JDT[dtype])) for a in (w, b)))
    return out


def _inputs(dtype, loss, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, DIMS[0]), dtype=np.float32)
    if loss == "mse":
        y = rng.random((BATCH, DIMS[-1]), dtype=np.float32)
    else:
        y = rng.integers(0, DIMS[-1], BATCH).astype(np.int32)
    jx = jnp.asarray(x, JDT[dtype])
    return jx, jnp.asarray(y), torch.from_numpy(np.array(jx.astype(
        jnp.float32))).to(getattr(torch, dtype)), torch.from_numpy(y)


def _tol(want: np.ndarray, dtype, ulps: int = 2) -> dict:
    top = float(np.abs(want).max())
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5 * top)
    return dict(rtol=0, atol=ulps * 2.0 ** (np.floor(np.log2(top)) - 7))


def _check(got: torch.Tensor, want, dtype, ulps: int = 2):
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **_tol(want, dtype, ulps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss", ["mse", "xent"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_train_step_matches_reference(opt, loss, dtype):
    np_params = _np_params(dtype)
    jx, jy, tx, ty = _inputs(dtype, loss)

    jopt = jmlp.make_optimizer(opt)
    jparams = [tuple(jnp.asarray(a) for a in wb) for wb in np_params]
    jstate = jopt.init(jparams)
    jstep = jmlp.make_train_step(jopt, loss)

    topt = tmlp.make_optimizer(opt)
    tparams = mlp_params_from_jax(np_params, device="cpu")
    tstate = (adagrad_state_from_jax(
        jax.tree.map(np.asarray, jstate[0].sum_of_squares), device="cpu")
        if opt == "adagrad" else topt.init(tparams))
    tstep = tmlp.make_train_step(topt, loss)

    for _ in range(STEPS):
        jparams, jstate, jl = jstep(jparams, jstate, jx, jy)
        same, tstate, tl = tstep(tparams, tstate, tx, ty)
        assert same is tparams  # the update is in place
        assert tl.dtype == torch.float32 and not tl.requires_grad
        np.testing.assert_allclose(
            float(tl), float(jl), rtol=1e-5 if dtype == "float32" else 2 ** -6)
    for (tw, tb), (jw, jb) in zip(tparams, jparams):
        _check(tw, jw, dtype)
        _check(tb, jb, dtype)
        assert not tw.requires_grad
    if opt == "adagrad":
        for (ta, tb), (ja, jb) in zip(tstate, jstate[0].sum_of_squares):
            _check(ta, ja, dtype, ulps=4)
            _check(tb, jb, dtype, ulps=4)


def test_train_step_learns_and_loss_kinds_differ():
    """Both losses fall over a few steps; "mse" and any other name give
    different losses on the same outputs (the latter on integer labels)."""
    np_params = _np_params("float32")
    losses = {}
    for loss in ("mse", "xent"):
        _, _, tx, ty = _inputs("float32", loss)
        params = mlp_params_from_jax(np_params, device="cpu")
        opt = tmlp.make_optimizer("sgd")
        step, state = tmlp.make_train_step(opt, loss), opt.init(params)
        losses[loss] = [float(step(params, state, tx, ty)[2])
                        for _ in range(20)]
        assert losses[loss][-1] < losses[loss][0]
    assert losses["mse"][0] != losses["xent"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_infer_step_matches_reference(dtype):
    np_params = _np_params(dtype)
    jx, _, tx, _ = _inputs(dtype, "mse")
    want = jmlp.infer_step([tuple(jnp.asarray(a) for a in wb)
                            for wb in np_params], jx)
    params = mlp_params_from_jax(np_params, device="cpu")
    for w, b in params:
        w.requires_grad_(True)
        b.requires_grad_(True)
    got = tmlp.infer_step(params, tx)
    assert not got.requires_grad  # no autograd graph
    _check(got, want, dtype)


def test_adagrad_state_from_jax_takes_mlp_pairs():
    np_params = _np_params("float32")
    acc = tmlp.Adagrad(0.01).init(mlp_params_from_jax(np_params, "cpu"))
    got = adagrad_state_from_jax(
        [tuple(np.full_like(a, 0.1) for a in wb) for wb in np_params], "cpu")
    for (a, b), (c, d) in zip(got, acc):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        torch.testing.assert_close(b, d, rtol=0, atol=0)
