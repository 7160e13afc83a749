"""MLP building blocks and optimizers (port of ``param_tpu/ops/mlp.py``).

Weights keep the reference's ``(din, dout)`` layout: ``y = x @ W + b``.  The
matmuls stay ``torch.matmul`` (cuBLAS on the card, full f32), as the
reference leaves them to XLA outside any Pallas kernel.

The optimizers follow optax, not ``torch.optim``: Adagrad starts its
accumulator at 0.1 and scales by ``where(acc > 0, rsqrt(acc + eps), 0)``
with eps = 1e-7 inside the square root (``torch.optim.Adagrad`` puts eps
outside and has no gate).  They update the parameters in place.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from param_tpu_torch.ops.sparse_update import adagrad_factor
from param_tpu_torch.utils.device import resolve_device

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def init_mlp(generator: torch.Generator, layer_dims: Sequence[int],
             dtype=torch.float32, device="cuda") -> Params:
    """He-init MLP params as a list of (W (din, dout), b (dout,)).

    ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    params = []
    for din, dout in zip(layer_dims[:-1], layer_dims[1:]):
        w = torch.randn((din, dout), generator=generator, dtype=dtype,
                        device=dev) * (2.0 / din) ** 0.5
        b = torch.zeros((dout,), dtype=dtype, device=dev)
        params.append((w, b))
    return params


def mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    for i, (w, b) in enumerate(params):
        x = torch.matmul(x, w) + b
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def tree_leaves(tree):
    """Tensors of a params tree (dict / list / tuple of tensors), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    return [t for sub in tree for t in tree_leaves(sub)]


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(tree_map(fn, v) for v in tree)


class Sgd:
    """optax.sgd: ``p += -lr * g``."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, params, grads, state):
        for p, g in zip(tree_leaves(params), grads):
            p.add_(-self.lr * g)
        return state


class Adagrad:
    """optax.adagrad: ``acc += g**2; p += -lr * g * where(acc > 0,
    rsqrt(acc + eps), 0)``; the state is a params-shaped accumulator tree."""

    def __init__(self, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        self.lr = lr
        self.acc0 = initial_accumulator_value
        self.eps = eps

    def init(self, params):
        return tree_map(lambda p: torch.full_like(p.detach(), self.acc0), params)

    @torch.no_grad()
    def update(self, params, grads, state):
        for p, a, g in zip(tree_leaves(params), tree_leaves(state), grads):
            a.add_(g * g)
            p.add_(g * adagrad_factor(a, self.eps) * -self.lr)
        return state


def make_optimizer(name: str, lr: float = 0.01):
    """sgd | adagrad, with optax semantics."""
    if name == "sgd":
        return Sgd(lr)
    if name == "adagrad":
        return Adagrad(lr)
    raise ValueError(f"unknown optimizer {name!r}")
