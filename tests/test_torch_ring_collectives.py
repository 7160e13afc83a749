"""The port's ring collectives (``param_tpu_torch.ops.ring_collectives``,
plain versions of K8a-d on CPU shards) against the reference's Pallas ring
kernels, run under ``jax.shard_map`` on the conftest CPU mesh in interpret
mode (remote DMA emulated), as ``tests/test_ring_collectives.py`` runs them.

The same numpy inputs go to both.  Agreement is bitwise in f32 and bf16
for every collective: the gathers and the copy move bytes, and the
all-reduce adds in the input dtype in the ring's hop order on both sides
(one correctly rounded add per hop).  bf16 inputs are made bf16-exact
before they are handed to either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from param_tpu.ops import ring_collectives as ref
from param_tpu_torch.ops import ring_collectives as port

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, local, dtype, seed):
    """(n * local[0], *local[1:]) values exact in ``dtype``, as f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n * local[0], *local[1:])).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(DTYPES[dtype][0])
                      .astype(jnp.float32))


def _reference(fn, x, n, dtype):
    """Per-device outputs of ``fn(local, "x")`` under shard_map over n
    CPU devices, as f32 numpy arrays."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    spec = P("x", *([None] * (x.ndim - 1)))
    f = jax.jit(jax.shard_map(lambda v: fn(v, "x"), mesh=mesh, in_specs=spec,
                              out_specs=P("x"), check_vma=False))
    out = np.asarray(f(jnp.asarray(x).astype(DTYPES[dtype][0]))
                     .astype(jnp.float32))
    return np.split(out, n, axis=0)


def _port(fn, x, n, dtype):
    shards = [torch.from_numpy(s.copy()).to(DTYPES[dtype][1])
              for s in np.split(x, n, axis=0)]
    return [o.float().numpy() for o in fn(shards)]


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.reshape(w.shape)
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_all_gather_matches_reference(n, dtype):
    x = _inputs(n, (8,), dtype, seed=n)
    _assert_bitwise(_port(port.ring_all_gather, x, n, dtype),
                    _reference(ref.ring_all_gather, x, n, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [4, 8])
def test_all_gather_2d_payload_matches_reference(n, dtype):
    x = _inputs(n, (2, 16), dtype, seed=10 + n)
    got = _port(port.ring_all_gather, x, n, dtype)
    assert got[0].shape == (n, 2, 16)
    _assert_bitwise(got, _reference(ref.ring_all_gather, x, n, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_all_reduce_matches_reference(n, dtype):
    x = _inputs(n, (n * 4, 3), dtype, seed=20 + n)
    got = _port(port.ring_all_reduce, x, n, dtype)
    _assert_bitwise(got, _reference(ref.ring_all_reduce, x, n, dtype))
    # and it is a sum over the ranks (f32: within rounding of the ring order)
    if dtype == "float32":
        want = x.reshape(n, -1, 3).sum(axis=0)
        np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_bidir_all_gather_matches_reference(n, dtype):
    x = _inputs(n, (8,), dtype, seed=30 + n)
    _assert_bitwise(_port(port.ring_all_gather_bidir, x, n, dtype),
                    _reference(ref.ring_all_gather_bidir, x, n, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loopback_matches_reference(dtype):
    x = _inputs(1, (256, 128), dtype, seed=40)
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    f = jax.jit(jax.shard_map(lambda v: ref.loopback_remote_copy(v, "x"),
                              mesh=mesh, in_specs=(P(),), out_specs=P(),
                              check_vma=False))
    want = np.asarray(f(jnp.asarray(x).astype(DTYPES[dtype][0]))
                      .astype(jnp.float32))
    _assert_bitwise(_port(port.loopback_remote_copy, x, 1, dtype), [want])


def test_all_reduce_needs_divisible_leading_dim():
    with pytest.raises(ValueError, match="divide"):
        port.ring_all_reduce([torch.zeros(6), torch.zeros(6), torch.zeros(6),
                              torch.zeros(6)])


def test_mixed_devices_are_refused():
    with pytest.raises(ValueError, match="all lie"):
        port.ring_all_gather([torch.zeros(4), torch.zeros(4, device="meta")])
