"""Inputs and weights of the DLRM-DCNv2 family made from ``--seed``, on the
device, with ``data.py``'s generators.

A configuration of this family gives each table its rows (``rows``) and
each feature its bag size (``multi_hot_sizes``).  A batch's ids are (b, L),
one row of L = the sizes' sum a sample, feature t's ids the t-th slice of
it, each id drawn alone by the traffic's distribution over its table.
Every (purpose, batch, shard, feature) has its own generator, keyed from
the seed (``data.stream_seed``), so one feature or one table can be made
again alone.  Tables are N(0, 1/rows) (``data.fill_table``), the MLPs
He-initialised, the cross layers' V and W Xavier-normal (std
sqrt(2 / (F + r))) with zero biases, F = (tables + 1) x dim the cross
net's width and r its rank.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from port_bench import data

_DENSE, _IDS, _LABELS, _TABLE, _MLP, _CROSS = 1, 2, 3, 4, 5, 6


def row_starts(cfg: dict) -> List[int]:
    """Each table's first row in the tables' flat (sum of rows, dim) view."""
    out, at = [], 0
    for n in cfg["rows"]:
        out.append(at)
        at += n
    return out


def width(cfg: dict) -> int:
    """F: the bottom output and every pooled feature, side by side."""
    return (len(cfg["rows"]) + 1) * cfg["emb_dim"]


def shard_ids(cfg: dict, traffic: dict, seed: int, batch: int, shard: int,
              shards: int, device) -> torch.Tensor:
    """Ids (b, L) int32 of shard ``shard`` of batch ``batch``, each
    feature's within its table."""
    b = traffic["batch"] // shards
    return torch.cat([
        data.ids(traffic, rows, (b, size),
                 data.generator(device, seed, _IDS, batch, shard, t), device)
        for t, (rows, size) in enumerate(zip(cfg["rows"],
                                             cfg["multi_hot_sizes"]))],
        dim=1)


def shard_batch(cfg: dict, traffic: dict, seed: int, batch: int, shard: int,
                shards: int, device) -> Tuple[torch.Tensor, ...]:
    """(dense (b, dense_dim) f32, ids (b, L) int32, labels (b,) f32)."""
    b = traffic["batch"] // shards
    dense = torch.randn((b, cfg["dense_dim"]), device=device,
                        generator=data.generator(device, seed, _DENSE, batch,
                                                 shard))
    labels = torch.randint(0, 2, (b,), device=device,
                           generator=data.generator(device, seed, _LABELS,
                                                    batch, shard)).float()
    return dense, shard_ids(cfg, traffic, seed, batch, shard, shards,
                            device), labels


def global_batch(cfg: dict, traffic: dict, seed: int, batch: int,
                 shards: int, device) -> Tuple[torch.Tensor, ...]:
    parts = [shard_batch(cfg, traffic, seed, batch, s, shards, device)
             for s in range(shards)]
    return tuple(torch.cat(p) for p in zip(*parts))


def table(cfg: dict, seed: int, t: int, device) -> torch.Tensor:
    """Table ``t`` as the program fills it (``data.fill_table``)."""
    out = torch.empty((cfg["rows"][t], cfg["emb_dim"]), dtype=torch.float32,
                      device=device)
    return data.fill_table(out, seed, t)


def mlp_dims(cfg: dict) -> Dict[str, List[int]]:
    return {"bot": [cfg["dense_dim"], *cfg["bot_mlp"]],
            "top": [width(cfg), *cfg["top_mlp"]]}


def dense_params(cfg: dict, seed: int, device) -> Dict[str, list]:
    """{"bot": [(W, b)], "top": [(W, b)], "cross": [(V (F, r), W (r, F),
    b (F,))]}."""
    gen = data.generator(device, seed, _MLP)
    out = {}
    for key, dims in mlp_dims(cfg).items():
        layers = []
        for din, dout in zip(dims[:-1], dims[1:]):
            w = torch.randn((din, dout), generator=gen, device=device)
            layers.append((w.mul_(math.sqrt(2.0 / din)),
                           torch.zeros(dout, device=device)))
        out[key] = layers
    gen = data.generator(device, seed, _CROSS)
    F, r = width(cfg), cfg["dcn_low_rank_dim"]
    std = math.sqrt(2.0 / (F + r))
    out["cross"] = [
        (torch.randn((F, r), generator=gen, device=device).mul_(std),
         torch.randn((r, F), generator=gen, device=device).mul_(std),
         torch.zeros(F, device=device))
        for _ in range(cfg["dcn_num_layers"])]
    return out


def dense_leaves(m: Dict[str, list]) -> Dict[str, torch.Tensor]:
    """{"bot.0.w": W, ..., "cross.0.v": V, "cross.0.w": W, "cross.0.b": b,
    ...} in the order of the layers."""
    out = {}
    for key in ("bot", "top"):
        for i, (w, b) in enumerate(m[key]):
            out[f"{key}.{i}.w"] = w
            out[f"{key}.{i}.b"] = b
    for i, (v, w, b) in enumerate(m["cross"]):
        out[f"cross.{i}.v"] = v
        out[f"cross.{i}.w"] = w
        out[f"cross.{i}.b"] = b
    return out
