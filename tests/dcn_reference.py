"""A plain DLRM-DCNv2 in PyTorch: the reference the port's DCN steps are
held to (``tests/test_torch_dlrm_dcn.py``).

It imports neither the port nor JAX, and runs in whatever dtype its inputs
have (the tests give it float64), with TF32 off, or with every product's
operands rounded to TF32 (``tf32``: the control that the tests' tolerances
must reject).  Parameters: ``tables`` a list of per-table (rows, D)
tensors, ``bot`` / ``top`` [(W (din, dout), b)], ``cross`` [(V (F, r),
W (r, F), b (F,))].

- forward: feature t's bag of sample b is the t-th slice of the sample's
  ids (``sizes``), summed from table t's rows; the bottom MLP (ReLU between
  layers, none after the last); x0 = the bottom output then the pooled
  features, flattened, F = (T + 1) D wide; for each cross layer
  ``x_{l+1} = x0 * ((x_l V) W + b) + x_l``; the top MLP on the last; mean
  binary cross-entropy on the logits;
- backward by autograd;
- the optimizers with optax semantics: SGD ``p -= lr g``; Adagrad ``a +=
  g^2; p -= lr g where(a > 0, rsqrt(a + eps), 0)``, tables and dense layers
  alike (a table row with no gradient does not move, as in a sparse step).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (to nearest even), in its
    own dtype."""
    f = x.float().contiguous()
    i = f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0xFFF + ((i >> 13) & 1)) & 0xFFFFE000
    i = torch.where(i >= 2**31, i - 2**32, i)
    return i.to(torch.int32).view(torch.float32).reshape(x.shape).to(x.dtype)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return torch.matmul(_Round.apply(a), _Round.apply(b))
    return torch.matmul(a, b)


class _Round(torch.autograd.Function):
    """TF32 rounding of an operand, whose gradient is rounded too (the
    tensor cores take the backward's operands rounded as well)."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def mlp(layers, x, tf32: bool = False):
    for i, (w, b) in enumerate(layers):
        x = mm(x, w, tf32) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def pooled(tables: List[torch.Tensor], ids: torch.Tensor,
           sizes: Sequence[int]) -> torch.Tensor:
    """(B, T, D): each feature's bag summed from its table."""
    out, at = [], 0
    for table, n in zip(tables, sizes):
        rows = table[ids[:, at:at + n].long()]  # (B, n, D)
        out.append(rows.sum(dim=1))
        at += n
    return torch.stack(out, dim=1)


def cross_net(x0: torch.Tensor, layers, tf32: bool = False) -> torch.Tensor:
    x = x0
    for v, w, b in layers:
        x = x0 * (mm(mm(x, v, tf32), w, tf32) + b) + x
    return x


def logits(params: Dict, dense: torch.Tensor, ids: torch.Tensor,
           sizes: Sequence[int], tf32: bool = False) -> torch.Tensor:
    bot = mlp(params["bot"], dense, tf32)
    x0 = torch.cat([bot, pooled(params["tables"], ids, sizes).reshape(
        dense.shape[0], -1)], dim=1)
    return mlp(params["top"], cross_net(x0, params["cross"], tf32), tf32)[:, 0]


def loss_fn(params, dense, ids, labels, sizes, tf32: bool = False):
    return F.binary_cross_entropy_with_logits(
        logits(params, dense, ids, sizes, tf32), labels)


def leaves(params: Dict) -> List[torch.Tensor]:
    """The tables, then the bottom MLP, the top MLP and the cross layers."""
    out = list(params["tables"])
    for key in ("bot", "top", "cross"):
        for layer in params[key]:
            out.extend(layer)
    return out


def value_and_grad(params, dense, ids, labels, sizes, tf32: bool = False):
    """(loss, the gradient of each of :func:`leaves`)."""
    xs = leaves(params)
    for x in xs:
        x.requires_grad_(True)
    loss = loss_fn(params, dense, ids, labels, sizes, tf32)
    grads = torch.autograd.grad(loss, xs)
    for x in xs:
        x.requires_grad_(False)
    return loss.detach(), list(grads)


def train(params, batches, sizes, opt: str, lr: float, eps: float = 1e-7,
          acc0: float = 0.1, tf32: bool = False):
    """Steps of ``opt`` ("sgd" or "adagrad") on ``batches`` (dense, ids,
    labels), updating ``params`` in place: (losses, the first step's
    gradients)."""
    xs = leaves(params)
    acc = [torch.full_like(x, acc0) for x in xs]
    losses, first = [], None
    for dense, ids, labels in batches:
        loss, grads = value_and_grad(params, dense, ids, labels, sizes, tf32)
        losses.append(float(loss))
        first = grads if first is None else first
        with torch.no_grad():
            for x, a, g in zip(xs, acc, grads):
                if opt == "sgd":
                    x.sub_(lr * g)
                else:
                    a.add_(g * g)
                    x.sub_(lr * g * torch.where(
                        a > 0, torch.rsqrt(a + eps), torch.zeros_like(a)))
    return losses, first
