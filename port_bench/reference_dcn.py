"""The plain reference of DLRM-DCNv2: its first training steps in plain
PyTorch, f32 with TF32 off.

It imports nothing of the program.  It makes the initial weights and the
checked batches again from the seed (``data_dcn.py``), keeps only the table
rows those batches touch, and follows the program's first three steps:

- forward: each feature's bag summed from its table's rows (the bag is the
  feature's slice of the sample's ids), the bottom MLP (ReLU between
  layers, none after the last), x0 = the bottom output then the pooled
  features, flattened (F = (tables + 1) x dim wide), then for each cross
  layer ``x_{l+1} = x0 * ((x_l V_l) W_l + b_l) + x_l`` (V_l (F, r), W_l
  (r, F)), the top MLP on the last, mean binary cross-entropy on the
  logits;
- backward by autograd: a table row's gradient is the sum over its
  occurrences;
- optimizer with optax semantics, dense and sparse alike (``reference.py``'s
  SGD and Adagrad: eps inside the root, the accumulator from the
  configuration's initial value, a row with no gradient does not move).

It gives what ``check.py`` compares: each step's loss, the sum of squares of
each leaf's first gradient and of each leaf's change after the three steps.
With ``tf32`` (every product's operands rounded to TF32) or ``half_batch``
(the second half of the rows left out), it stands in for the program to
read the control and the fault.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench import data_dcn
from port_bench import reference as dot_reference

CHECKED_STEPS = dot_reference.CHECKED_STEPS


def cross_net(x0: torch.Tensor, layers, tf32: bool) -> torch.Tensor:
    """The low-rank cross layers by their equation."""
    x = x0
    for v, w, b in layers:
        h = dot_reference._mm(dot_reference._mm(x, v, tf32), w, tf32) + b
        x = x0 * h + x
    return x


def logits(params, pooled: torch.Tensor, dense_x: torch.Tensor,
           tf32: bool) -> torch.Tensor:
    bot = dot_reference.mlp(params["bot"], dense_x, tf32)
    x0 = torch.cat([bot, pooled.reshape(pooled.shape[0], -1)], dim=1)
    return dot_reference.mlp(params["top"], cross_net(x0, params["cross"],
                                                      tf32), tf32)[:, 0]


def _sumsq(x: torch.Tensor) -> float:
    return float(torch.sum(x.double() * x.double()))


def readings(cfg: dict, traffic: dict, seed: int, shards: int, device,
             tf32: bool = False, half_batch: bool = False) -> dict:
    """{"loss": [3 floats], "grad_sq": {leaf: [float]}, "change_sq": {leaf:
    [float]}} of the first three steps on the seed's batches 0-2, on one
    card (the family's tables of unequal rows are not sharded)."""
    if shards != 1:
        raise ValueError("DLRM-DCNv2's tables of unequal rows run on one card")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32, as configured
    opt = cfg["optimizer"]
    lr = float(cfg["lr"])
    eps = float(cfg["adagrad_eps"])
    acc0 = float(cfg["adagrad_initial_accumulator"])
    T = len(cfg["rows"])
    batches = [data_dcn.global_batch(cfg, traffic, seed, k, 1, device)
               for k in range(CHECKED_STEPS)]
    cols, at = [], 0
    for size in cfg["multi_hot_sizes"]:
        cols.append(slice(at, at + size))
        at += size
    # the rows the checked steps touch, and each bag's ids among them
    local: List[List[torch.Tensor]] = []
    weights: List[torch.Tensor] = []
    for t in range(T):
        ids_t = [b[1][:, cols[t]] for b in batches]
        u = torch.unique(torch.cat([i.reshape(-1) for i in ids_t]))
        local.append([torch.searchsorted(u, i.contiguous()) for i in ids_t])
        full = data_dcn.table(cfg, seed, t, device)
        weights.append(full[u.long()].clone())
        del full
    dense0 = data_dcn.dense_leaves(data_dcn.dense_params(cfg, seed, device))
    dense = {k: v.clone() for k, v in dense0.items()}
    names = list(dense)
    table0 = [w.clone() for w in weights]
    acc_t = [torch.full_like(w, acc0) for w in weights]
    acc_d = {k: torch.full_like(v, acc0) for k, v in dense.items()}
    n_rows = traffic["batch"]
    keep = slice(0, n_rows // 2 if half_batch else n_rows)
    losses: List[float] = []
    grad_sq: Dict[str, List[float]] = {}
    for k, (dx, _, labels) in enumerate(batches):
        leaves = weights + [dense[n] for n in names]
        for v in leaves:
            v.requires_grad_(True)
        pooled = torch.stack([weights[t][local[t][k][keep].long()].sum(dim=1)
                              for t in range(T)], dim=1)
        params = {
            key: [(dense[f"{key}.{i}.w"], dense[f"{key}.{i}.b"])
                  for i in range(len(cfg[f"{key}_mlp"]))]
            for key in ("bot", "top")}
        params["cross"] = [(dense[f"cross.{i}.v"], dense[f"cross.{i}.w"],
                            dense[f"cross.{i}.b"])
                           for i in range(cfg["dcn_num_layers"])]
        loss = F.binary_cross_entropy_with_logits(
            logits(params, pooled, dx[keep], tf32), labels[keep])
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for v in leaves:
                v.requires_grad_(False)
            if k == 0:
                for t in range(T):
                    grad_sq[f"table.{t}"] = [_sumsq(grads[t])]
                for j, name in enumerate(names):
                    grad_sq[name] = [_sumsq(grads[T + j])]
            for t in range(T):
                dot_reference._update(opt, weights[t], acc_t[t], grads[t],
                                      lr, eps)
            for j, name in enumerate(names):
                dot_reference._update(opt, dense[name], acc_d[name],
                                      grads[T + j], lr, eps)
    change_sq = {f"table.{t}": [_sumsq(weights[t] - table0[t])]
                 for t in range(T)}
    for name in names:
        change_sq[name] = [_sumsq(dense[name] - dense0[name])]
    return {"loss": losses, "grad_sq": grad_sq, "change_sq": change_sq}
