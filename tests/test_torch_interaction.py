"""The port's dot interaction on the CPU (``models/dlrm.dot_interaction``:
the autograd Function over ``kernels/interaction.py``'s plain versions)
against the reference's ``dot_interaction`` and its ``jax.vjp``.

Shapes: the benchmark cells' (m = 27, D = 128; m = 9, D = 64) and the
smallest triangle (m = 2), each at a batch of 1 and of 7; ``pooled`` also
as a non-contiguous view (the sharded step's exchange can hand one over).
Inputs have rows of norm ~1, so dots and gradients are O(1).  Tolerance:
f32 rtol 1e-5, atol 1e-5 (sums of up to 128 products, or 27 gradient
terms, taken in another order than XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.models import dlrm as jdlrm
from param_tpu_torch.kernels.interaction import (
    dot_interaction_bwd_plain, dot_interaction_plain,
)
from param_tpu_torch.models.dlrm import dot_interaction

SHAPES = [(27, 128), (9, 64), (2, 16)]  # (m, D)


def _inputs(batch, m, dim, seed=0):
    rng = np.random.default_rng(seed)
    scale = dim ** -0.5
    bot = (rng.standard_normal((batch, dim)) * scale).astype(np.float32)
    pooled = (rng.standard_normal((batch, m - 1, dim)) * scale).astype(
        np.float32)
    cot = rng.standard_normal((batch, dim + m * (m - 1) // 2)).astype(
        np.float32)
    return bot, pooled, cot


def _jax(bot, pooled, cot):
    out, vjp = jax.vjp(jdlrm.dot_interaction, jnp.asarray(bot),
                       jnp.asarray(pooled))
    g_bot, g_pooled = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(g_bot), np.asarray(g_pooled)


def _port(bot, pooled, cot):
    b = torch.from_numpy(bot).requires_grad_(True)
    p = torch.from_numpy(pooled).requires_grad_(True)
    out = dot_interaction(b, p)
    g_bot, g_pooled = torch.autograd.grad(out, (b, p), torch.from_numpy(cot))
    return out.detach().numpy(), g_bot.numpy(), g_pooled.numpy()


def _close(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 7])
@pytest.mark.parametrize("m,dim", SHAPES)
def test_function_matches_jax_forward_and_vjp(m, dim, batch):
    bot, pooled, cot = _inputs(batch, m, dim)
    want = _jax(bot, pooled, cot)
    got = _port(bot, pooled, cot)
    _close(got, want)


@pytest.mark.parametrize("m,dim", SHAPES)
def test_function_on_a_non_contiguous_pooled_view(m, dim):
    """``pooled`` as every other column of a (B, T, 2D) leaf: the same
    outputs and gradients as the reference on its values."""
    bot, pooled, cot = _inputs(7, m, dim, seed=1)
    wide = np.zeros(pooled.shape[:2] + (2 * dim,), np.float32)
    wide[:, :, ::2] = pooled
    leaf = torch.from_numpy(wide).requires_grad_(True)
    view = leaf[:, :, ::2]
    assert not view.is_contiguous()
    b = torch.from_numpy(bot).requires_grad_(True)
    out = dot_interaction(b, view)
    g_bot, g_leaf = torch.autograd.grad(out, (b, leaf), torch.from_numpy(cot))
    assert not g_leaf[:, :, 1::2].any()
    want = _jax(bot, pooled, cot)
    _close((out.detach().numpy(), g_bot.numpy(),
            g_leaf[:, :, ::2].numpy()), want)


@pytest.mark.parametrize("m,dim", SHAPES)
def test_plain_backward_is_the_forwards_vjp(m, dim):
    """The written-out backward (G by assignment, ``bmm(G, z) + bmm(G^T,
    z)``) against autograd of the plain forward, in f64 (rtol 1e-12: the
    same products, perhaps summed in another order)."""
    bot, pooled, cot = (torch.from_numpy(a).double()
                        for a in _inputs(7, m, dim, seed=2))
    b, p = bot.requires_grad_(True), pooled.requires_grad_(True)
    want = torch.autograd.grad(dot_interaction_plain(b, p), (b, p), cot)
    got = dot_interaction_bwd_plain(cot, bot.detach(), pooled.detach())
    for g, w in zip(got, want, strict=True):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_ops_on_the_cpu_are_the_plain_versions():
    bot, pooled, cot = (torch.from_numpy(a) for a in _inputs(5, 9, 64))
    out = torch.ops.param_tpu_torch.dot_interaction.default(bot, pooled)
    assert torch.equal(out, dot_interaction_plain(bot, pooled))
    got = torch.ops.param_tpu_torch.dot_interaction_bwd.default(cot, bot,
                                                                pooled)
    for g, w in zip(got, dot_interaction_bwd_plain(cot, bot, pooled),
                    strict=True):
        assert torch.equal(g, w)
    meta = torch.ops.param_tpu_torch.dot_interaction.default(
        bot.to("meta"), pooled.to("meta"))
    assert meta.shape == (5, 64 + 36) and meta.device.type == "meta"
