"""MLP building blocks and optimizers (port of ``param_tpu/ops/mlp.py``).

Weights keep the reference's ``(din, dout)`` layout: ``y = x @ W + b``.  The
matmuls stay ``torch.matmul`` (cuBLAS on the card, full f32), as the
reference leaves them to XLA outside any Pallas kernel.

The optimizers follow optax, not ``torch.optim``: Adagrad starts its
accumulator at 0.1 and scales by ``where(acc > 0, rsqrt(acc + eps), 0)``
with eps = 1e-7 inside the square root (``torch.optim.Adagrad`` puts eps
outside and has no gate).  They update the parameters in place, and so
does :func:`make_train_step`'s step.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from param_tpu_torch.ops.sparse_update import adagrad_factor
from param_tpu_torch.utils.device import resolve_device

if TYPE_CHECKING:
    from param_tpu_torch.models.parallel import MeshGroups

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def mlp_flops(layers: Sequence[int], batch: int, fwd_only: bool = False) -> int:
    """(2 or 6) * sum(l_i * l_{i+1}) * batch: a forward, or a forward and
    its two backward products."""
    f = sum(a * b for a, b in zip(layers[:-1], layers[1:]))
    return (2 if fwd_only else 6) * f * batch


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


def mlp_tp_shard(params: Params, tp_rank: int, tp: int) -> Params:
    """Tensor-parallel rank ``tp_rank``'s MLP of ``tp`` (dry-run path 5's
    sharding): each layer of output width above 1 column-sharded (its
    column block of W and b), a width-1 layer whole.  New tensors."""
    out = []
    for w, b in params:
        if w.shape[1] > 1:
            if w.shape[1] % tp:
                raise ValueError(f"tp {tp} must divide the width {w.shape[1]}")
            c = w.shape[1] // tp
            w, b = w[:, tp_rank * c:(tp_rank + 1) * c], b[
                tp_rank * c:(tp_rank + 1) * c]
        out.append((w.contiguous().clone(), b.contiguous().clone()))
    return out


def make_tp_mlp_train_step(groups: MeshGroups, lr: float = 0.01):
    """(shard, x, y) -> (shard', loss): the dp x tp MLP step of dry-run path
    5 on this rank's :func:`mlp_tp_shard` and its dp shard of the batch.

    A column-sharded layer reads its input through ``copy_to_group`` and
    its output slice goes to the next layer through ``gather_from_group``;
    together their backwards make the reduce-scatter that transposes the
    gather.  The last layer must be the width-1 logit, which stays whole.
    A layer is taken as sharded when its width is below the next layer's
    input width (in a tp group of one the two coincide, and so do the
    results).  The loss is mean((logit - y)^2) over the full batch and the
    step SGD with the gradients averaged over dp.  Not in place."""
    # imported here: the models package imports this module
    from param_tpu_torch.models.parallel import (
        all_reduce_mean, copy_to_group, gather_from_group,
    )

    tp, dp = groups.tp, groups.dp

    def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
        for i, (w, b) in enumerate(params):
            sharded = i + 1 < len(params) and (
                w.shape[1] < params[i + 1][0].shape[0])
            if sharded:
                x = copy_to_group(x, tp)
            x = torch.matmul(x, w) + b
            if i < len(params) - 1:
                x = torch.relu(x)
            if sharded:
                x = gather_from_group(x, tp)
        return x

    def step(params: Params, x: torch.Tensor, y: torch.Tensor):
        if params[-1][0].shape[1] != 1:
            raise ValueError("the last layer must be the width-1 logit")
        ts = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            local = [tuple(ts[2 * i:2 * i + 2]) for i in range(len(params))]
            loss = torch.mean(torch.square(forward(local, x)[:, 0] - y))
            grads = torch.autograd.grad(loss, ts)
        grads = all_reduce_mean(list(grads), dp.pg, dp.size)
        loss, = all_reduce_mean([loss.detach()], dp.pg, dp.size)
        new = [p - lr * g for p, g in zip(tree_leaves(params), grads)]
        return [tuple(new[2 * i:2 * i + 2]) for i in range(len(params))], loss

    return step


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


def make_train_step(optimizer, loss: str = "mse"):
    """``train_step(params, opt_state, x, y) -> (params, opt_state, loss)``:
    the forward (:func:`mlp_forward`, its output upcast to f32), the loss,
    the backward and ``optimizer``'s update (:class:`Sgd` / :class:`Adagrad`).

    ``loss`` "mse" is ``mean((out - y)**2)``; any other value is softmax
    cross-entropy of ``out`` against integer labels ``y``, averaged over
    the batch.  The update is in place: the params and state returned are
    the caller's own tensors, updated (the reference returns new arrays).
    The loss is a detached f32 scalar tensor."""

    def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor):
        out = mlp_forward(params, x).float()
        if loss == "mse":
            return torch.mean((out - y) ** 2)
        return F.cross_entropy(out, y.long())

    def train_step(params: Params, opt_state, x: torch.Tensor,
                   y: torch.Tensor):
        local = [tuple(t.detach().requires_grad_(True) for t in wb)
                 for wb in params]
        with torch.enable_grad():
            value = loss_fn(local, x, y)
            grads = torch.autograd.grad(value, tree_leaves(local))
        opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, value.detach()

    return train_step


@torch.no_grad()
def infer_step(params: Params, x: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_forward` without autograd."""
    return mlp_forward(params, x)
