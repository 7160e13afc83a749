"""The plain reference: DLRM's first training steps in plain PyTorch.

It imports nothing of the program.  It makes the initial weights and the
checked batches again from the seed (``data.py``), keeps only the table rows
those batches touch, and follows the program's first three steps:

- forward: each table's bags summed from its rows, the bottom MLP (ReLU
  between layers, none after the last), the dot interaction (the bottom
  output, then the strict lower triangle of z z^T in row-major order), the
  top MLP, mean binary cross-entropy on the logits;
- backward by autograd: a table row's gradient is the sum over its
  occurrences;
- optimizer with optax semantics: SGD ``p -= lr g``; Adagrad ``a += g^2;
  p -= lr g where(a > 0, rsqrt(a + eps), 0)`` with ``a`` starting at the
  configuration's initial accumulator, dense and sparse alike (a row with
  no gradient does not move).

It gives what the check compares (``check.py``): the loss of each step, the
sum of squares of each leaf's first gradient and of each leaf's change after
the three steps.  The same function, with ``tf32`` or a fault, stands in for
the program to read the control and the faults.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from port_bench import data

CHECKED_STEPS = 3


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), as the
    tensor cores take float32 operands."""
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0xFFF + ((i >> 13) & 1)) & 0xFFFFE000
    i = torch.where(i >= 2**31, i - 2**32, i)
    return i.to(torch.int32).view(torch.float32).reshape(x.shape)


class _Tf32Matmul(torch.autograd.Function):
    """A product whose operands are rounded to TF32, forward and backward,
    accumulated in f32: what TF32 tensor cores compute."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (torch.matmul(g, b.transpose(-1, -2)),
                torch.matmul(a.transpose(-1, -2), g))


def _mm(a, b, tf32: bool):
    return _Tf32Matmul.apply(a, b) if tf32 else torch.matmul(a, b)


def mlp(layers, x, tf32: bool):
    for i, (w, b) in enumerate(layers):
        x = _mm(x, w, tf32) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def logits(dense_params, pooled, dense_x, tf32: bool):
    bot = mlp(dense_params["bot"], dense_x, tf32)
    z = torch.cat([bot[:, None, :], pooled], dim=1)
    zz = _mm(z, z.transpose(1, 2), tf32)
    m = z.shape[1]
    li, lj = torch.tril_indices(m, m, offset=-1, device=z.device)
    feat = torch.cat([bot, zz[:, li, lj]], dim=1)
    return mlp(dense_params["top"], feat, tf32)[:, 0]


def _sumsq(x: torch.Tensor) -> float:
    return float(torch.sum(x.double() * x.double()))


def readings(cfg: dict, traffic: dict, seed: int, shards: int, device,
             tf32: bool = False, half_batch: bool = False,
             local_dense_grads: bool = False) -> dict:
    """{"loss": [3 floats], "grad_sq": {leaf: [float]}, "change_sq": {leaf:
    [float]}} of the first three steps on the seed's batches 0-2.

    The faults, for reading what they would give: ``half_batch`` drops the
    second half of each shard's rows and takes the mean over the rest;
    ``local_dense_grads`` leaves out the dense gradients' mean over the
    shards, so each shard's MLPs move by its own rows' gradient (a list of
    one reading a shard for each dense leaf)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32, as configured
    opt = cfg["optimizer"]
    lr = float(cfg["lr"])
    eps = float(cfg.get("adagrad_eps", 1e-7))
    acc0 = float(cfg.get("adagrad_initial_accumulator", 0.1))
    T = cfg["num_tables"]
    batches = [data.global_batch(cfg, traffic, seed, k, shards, device)
               for k in range(CHECKED_STEPS)]
    # the rows the checked steps touch, and each bag's ids among them
    local: List[List[torch.Tensor]] = []
    weights: List[torch.Tensor] = []
    for t in range(T):
        ids_t = [b[1][:, t, :] for b in batches]
        u = torch.unique(torch.cat([i.reshape(-1) for i in ids_t]))
        local.append([torch.searchsorted(u, i.contiguous()) for i in ids_t])
        full = data.table(cfg, seed, t, device)
        weights.append(full[u.long()].clone())
        del full
    replicas = shards if local_dense_grads else 1
    dense0 = data.mlps(cfg, seed, device)
    dense = [data.dense_leaves(data.mlps(cfg, seed, device))
             for _ in range(replicas)]
    table0 = [w.clone() for w in weights]
    acc_t = [torch.full_like(w, acc0) for w in weights]
    acc_d = [{k: torch.full_like(v, acc0) for k, v in d.items()}
             for d in dense]
    losses: List[float] = []
    grad_sq: Dict[str, List[float]] = {}
    b_shard = traffic["batch"] // shards
    keep = b_shard // 2 if half_batch else b_shard
    for k, (dx, _, labels) in enumerate(batches):
        leaves = weights + [v for d in dense for v in d.values()]
        for v in leaves:
            v.requires_grad_(True)
        shard_losses = []
        for s in range(shards):
            rsel = slice(s * b_shard, s * b_shard + keep)
            pooled = torch.stack(
                [weights[t][local[t][k][rsel].long()].sum(dim=1)
                 for t in range(T)], dim=1)
            d = dense[s if local_dense_grads else 0]
            params = {key: [(d[f"{key}.{i}.w"], d[f"{key}.{i}.b"])
                            for i in range(len(dense0[key]))]
                      for key in ("bot", "top")}
            out = logits(params, pooled, dx[rsel], tf32)
            shard_losses.append(F.binary_cross_entropy_with_logits(
                out, labels[rsel]))
        loss = torch.stack(shard_losses).mean()
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g_tab = list(grads[:T])
            g_den = list(grads[T:])
            if local_dense_grads:  # each shard's own mean, not the mean's share
                g_den = [g * shards for g in g_den]
            names = list(dense[0])
            for v in leaves:
                v.requires_grad_(False)
            if k == 0:
                for t in range(T):
                    grad_sq[f"table.{t}"] = [_sumsq(g_tab[t])]
                for j, name in enumerate(names):
                    grad_sq[name] = [_sumsq(g_den[r * len(names) + j])
                                     for r in range(replicas)]
            for t in range(T):
                _update(opt, weights[t], acc_t[t], g_tab[t], lr, eps)
            for r in range(replicas):
                for j, name in enumerate(names):
                    _update(opt, dense[r][name], acc_d[r][name],
                            g_den[r * len(names) + j], lr, eps)
    p0 = data.dense_leaves(dense0)
    change_sq = {f"table.{t}": [_sumsq(weights[t] - table0[t])]
                 for t in range(T)}
    for name in p0:
        change_sq[name] = [_sumsq(d[name] - p0[name]) for d in dense]
    return {"loss": losses, "grad_sq": grad_sq, "change_sq": change_sq}


def _update(opt: str, p: torch.Tensor, a: Optional[torch.Tensor],
            g: torch.Tensor, lr: float, eps: float) -> None:
    if opt == "sparse_sgd":
        p.sub_(lr * g)
    elif opt == "sparse_adagrad":
        a.add_(g * g)
        p.sub_(lr * g * torch.where(a > 0, torch.rsqrt(a + eps),
                                    torch.zeros_like(a)))
    else:
        raise ValueError(f"unknown optimizer {opt!r}")
