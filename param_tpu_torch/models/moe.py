"""Expert-parallel Mixture-of-Experts layer, switch-style top-1 (port of
``param_tpu/models/moe.py``).

One FFN expert per rank of a group; tokens are routed top-1 with a fixed
per-sender capacity and dispatched and returned by the tiled all-to-all
(:func:`~param_tpu_torch.models.parallel.all_to_all`):

    router:   probs = softmax(x @ wr) in f32; expert = argmax (the first
              maximum, as ``jnp.argmax``), prob = the max, cast to x's dtype
    dispatch: each sender packs at most C = ceil(cf * T / E) tokens per
              expert into an (E, C, D) buffer; tokens beyond capacity drop
    expert:   y = gelu(x @ w1) @ w2 (tanh gelu, ``jax.nn.gelu``'s default)
    combine:  all-to-all back, unpack to token positions, scale by prob
              (dropped tokens come back as zeros)

A token's slot is its FIFO rank among the same sender's tokens for the
same expert (a cumsum over local token order), so the layer and the
single-device oracle :func:`moe_apply_reference` agree.  A dropped token's
slot is >= C: JAX clamps such gather indices, torch raises, so the port
clamps them and the keep mask zeroes the row.

Parameters: ``wr`` (E, n) replicated, ``w1`` (n, E, F) and ``w2`` (n, F,
E) stacked per expert; rank e holds expert e's slabs
(:func:`expert_shard`).  The expert count equals the group size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from param_tpu_torch.backend.base import CommGroup
from param_tpu_torch.models.parallel import all_to_all
from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.dtypes import dtype_from_name

KEYS = ("w1", "w2", "wr")


@dataclass(frozen=True)
class MoeConfig:
    emb: int
    ffn: int
    n_experts: int
    capacity_factor: float = 1.25
    dtype: str = "float32"

    def capacity(self, tokens_per_sender: int) -> int:
        """Per-(sender, expert) slot count."""
        return max(1, math.ceil(
            self.capacity_factor * tokens_per_sender / self.n_experts))


def init_moe_params(gen: torch.Generator, cfg: MoeConfig,
                    device="cuda") -> Dict:
    """N(0, 1 / fan-in) router and expert weights in ``cfg.dtype``, drawn
    from ``gen`` on ``device``."""
    dev = resolve_device(device)
    dt = dtype_from_name(cfg.dtype)
    e, f, n = cfg.emb, cfg.ffn, cfg.n_experts

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(shape[-2])).to(dt)

    return {"wr": w(e, n), "w1": w(n, e, f), "w2": w(n, f, e)}


def expert_shard(params: Dict, e: int) -> Dict:
    """Rank ``e``'s parameters: the router and expert e's (1, E, F) / (1,
    F, E) slabs (the reference's ``moe_param_specs``: ``wr`` replicated,
    ``w1`` / ``w2`` split on the expert axis)."""
    return {"wr": params["wr"], "w1": params["w1"][e:e + 1],
            "w2": params["w2"][e:e + 1]}


def _route(x: torch.Tensor, wr: torch.Tensor, n_experts: int, cap: int):
    """-> (expert, slot, keep, prob) per token; slot = FIFO rank among this
    sender's tokens bound for the same expert."""
    probs = torch.softmax(x.float() @ wr.float(), dim=-1)  # (T, E)
    expert = torch.argmax(probs, dim=-1)
    prob = probs.amax(dim=-1)
    onehot = F.one_hot(expert, n_experts)
    slot = (onehot * (torch.cumsum(onehot, dim=0) - 1)).sum(dim=-1)
    keep = slot < cap
    return expert, slot, keep, prob.to(x.dtype)


def _expert_ffn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    return F.gelu(x @ w1, approximate="tanh") @ w2


def moe_apply_ep(params: Dict, x: torch.Tensor, group: CommGroup,
                 cfg: MoeConfig) -> torch.Tensor:
    """The sharded layer on one rank: ``x`` is its (T, D) token shard,
    ``params`` its :func:`expert_shard`; returns the (T, D) output."""
    t, d = x.shape
    n = cfg.n_experts
    if group.size != n:
        raise ValueError(f"{n} experts need a group of {n}, got {group.size}")
    cap = cfg.capacity(t)
    expert, slot, keep, prob = _route(x, params["wr"], n, cap)
    flat = expert * cap + slot.clamp(max=cap - 1)
    keep = keep[:, None].to(x.dtype)
    disp = torch.zeros((n * cap, d), dtype=x.dtype, device=x.device)
    disp = disp.index_add(0, flat, x * keep)  # a dropped token adds zeros
    # block e goes to rank e; received block s = sender s's tokens for me
    recv = all_to_all(disp, group)
    h = _expert_ffn(recv, params["w1"][0], params["w2"][0])
    back = all_to_all(h, group)  # (n * cap, d), block e from expert e
    return back[flat] * keep * prob[:, None]


def moe_apply_reference(params: Dict, x: torch.Tensor, cfg: MoeConfig,
                        n_senders: int) -> torch.Tensor:
    """Single-device oracle with the same semantics: the tokens split into
    ``n_senders`` contiguous shards, each with its own per-expert FIFO
    capacity, as the ep layer's senders.  Each expert's FFN runs on the
    rows routed to it (the reference gathers a weight per token, which at
    full width would not fit the card)."""
    t_total, d = x.shape
    t = t_total // n_senders
    n = cfg.n_experts
    cap = cfg.capacity(t)
    outs = []
    for s in range(n_senders):
        xs = x[s * t:(s + 1) * t]
        expert, _, keep, prob = _route(xs, params["wr"], n, cap)
        y = torch.zeros_like(xs)
        for e in range(n):
            rows = torch.nonzero(expert == e).flatten()
            y[rows] = _expert_ffn(xs[rows], params["w1"][e], params["w2"][e])
        outs.append(y * (keep.to(x.dtype) * prob)[:, None])
    return torch.cat(outs)


def make_moe_train_step(group: CommGroup, cfg: MoeConfig, lr: float = 1e-3):
    """(params, x) -> (params', loss): one SGD step of x -> x + moe(x) with
    mean-square loss on each rank's token shard.  The router's gradient is
    summed over the group (token shards differ per rank); each expert's
    arrives summed over the senders by the all-to-all's transpose.  The
    returned loss is the mean of the ranks' losses.  Not in place."""

    def step(params: Dict, x: torch.Tensor):
        ts = [params[k].detach().requires_grad_(True) for k in KEYS]
        with torch.enable_grad():
            y = x + moe_apply_ep(dict(zip(KEYS, ts)), x, group, cfg)
            loss = torch.mean(torch.square(y.float()))
            grads = list(torch.autograd.grad(loss, ts))
        wr = KEYS.index("wr")
        grads[wr] = grads[wr].contiguous()
        dist.all_reduce(grads[wr], group=group.pg)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group.pg)
        new = {k: (params[k].float() - lr * g.float()).to(params[k].dtype)
               for k, g in zip(KEYS, grads)}
        return new, loss / group.size

    return step
