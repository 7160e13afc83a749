"""Inputs and weights made from ``--seed``, on the device.

The batches are a frozen copy of the arithmetic of
``param_tpu_torch/models/dlrm_data.py`` (``RandomDataset`` with
``gen_indices``): dense features N(0, 1), labels 0 or 1 with probability
1/2, ids uniform over [0, rows) or Zipf(alpha) draws wrapped as
``(z - 1) % rows``.  The Zipf draws follow numpy's ``random_zipf``
(Devroye's rejection method).  They are drawn with a ``torch.Generator`` on
the device, not numpy's, so that set-up takes no host time: the numbers
differ from the port's generator, the distributions do not.

Every (purpose, batch, shard) has its own generator, keyed from the seed by
``numpy.random.SeedSequence``: shard r of batch b is the same on one card
as on four, and one table or one shard can be made again alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

_DENSE, _IDS, _LABELS, _TABLE, _MLP = 1, 2, 3, 4, 5


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for (seed, tags); any whole ``seed``."""
    entropy = [abs(int(seed)), 1 if seed < 0 else 0, *map(int, tags)]
    lo, hi = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *tags))


def zipf_draws(gen: torch.Generator, alpha: float, count: int,
               device) -> torch.Tensor:
    """``count`` Zipf(alpha) draws (alpha > 1) as float64 whole numbers, by
    numpy's ``random_zipf``: U in (Umin, 1], V in [0, 1),
    X = floor(U ** (-1 / (alpha - 1))), accepted where
    V X (T - 1) / (b - 1) <= T / b with T = (1 + 1/X) ** (alpha - 1) and
    b = 2 ** (alpha - 1); X outside [1, 2**63 - 1] is drawn again."""
    am1 = alpha - 1.0
    b = 2.0 ** am1
    int_max = float(2**63 - 1)
    umin = int_max ** -am1
    out: List[torch.Tensor] = []
    have = 0
    while have < count:
        n = int((count - have) * 1.25) + 1024
        u01 = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
        v = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
        u = u01 * umin + (1.0 - u01)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x <= int_max) & (x >= 1.0) & (v * x * (t - 1.0) / (b - 1.0)
                                           <= t / b)
        x = x[ok]
        out.append(x)
        have += x.numel()
    return torch.cat(out)[:count]


def ids(traffic: dict, rows: int, shape, gen: torch.Generator,
        device) -> torch.Tensor:
    """int32 ids of ``shape`` in [0, rows), by the traffic's distribution."""
    kind = traffic["ids"]
    if kind == "uniform":
        return torch.randint(0, rows, shape, generator=gen, device=device,
                             dtype=torch.int32)
    if kind == "zipf":
        z = zipf_draws(gen, float(traffic["zipf_alpha"]), math.prod(shape),
                       device)
        return torch.fmod(z - 1.0, float(rows)).to(torch.int32).reshape(shape)
    raise ValueError(f"unknown id distribution {kind!r}")


def shard_ids(cfg: dict, traffic: dict, seed: int, batch: int, shard: int,
              shards: int, device) -> torch.Tensor:
    """Ids (b, T, nnz) of shard ``shard`` of batch ``batch``."""
    b = traffic["batch"] // shards
    gen = generator(device, seed, _IDS, batch, shard)
    return ids(traffic, cfg["rows_per_table"],
               (b, cfg["num_tables"], cfg["nnz"]), gen, device)


def shard_batch(cfg: dict, traffic: dict, seed: int, batch: int, shard: int,
                shards: int, device) -> Tuple[torch.Tensor, ...]:
    """(dense (b, dense_dim) f32, ids (b, T, nnz) int32, labels (b,) f32):
    rows [shard * b, (shard + 1) * b) of global batch ``batch``, b =
    traffic batch / shards."""
    b = traffic["batch"] // shards
    dense = torch.randn((b, cfg["dense_dim"]), device=device,
                        generator=generator(device, seed, _DENSE, batch,
                                            shard))
    labels = torch.randint(0, 2, (b,), device=device,
                           generator=generator(device, seed, _LABELS, batch,
                                               shard)).float()
    return dense, shard_ids(cfg, traffic, seed, batch, shard, shards,
                            device), labels


def global_batch(cfg: dict, traffic: dict, seed: int, batch: int,
                 shards: int, device) -> Tuple[torch.Tensor, ...]:
    """The whole of batch ``batch``: its shards concatenated in order."""
    parts = [shard_batch(cfg, traffic, seed, batch, s, shards, device)
             for s in range(shards)]
    return tuple(torch.cat(p) for p in zip(*parts))


def fill_table(out: torch.Tensor, seed: int, table: int) -> torch.Tensor:
    """Table ``table``'s initial rows, N(0, 1/rows), written into ``out``
    (rows, D) in one call."""
    gen = generator(out.device, seed, _TABLE, table)
    return out.normal_(0.0, 1.0 / math.sqrt(out.shape[0]), generator=gen)


def table(cfg: dict, seed: int, t: int, device) -> torch.Tensor:
    """Table ``t`` as :func:`fill_table` made it, made again."""
    out = torch.empty((cfg["rows_per_table"], cfg["emb_dim"]),
                      dtype=torch.float32, device=device)
    return fill_table(out, seed, t)


def interaction_dim(cfg: dict) -> int:
    m = cfg["num_tables"] + 1
    return cfg["emb_dim"] + m * (m - 1) // 2


def mlp_dims(cfg: dict) -> Dict[str, List[int]]:
    return {"bot": [cfg["dense_dim"], *cfg["bot_mlp"]],
            "top": [interaction_dim(cfg), *cfg["top_mlp"]]}


def mlps(cfg: dict, seed: int, device) -> Dict[str, list]:
    """He-initialised MLPs, [(W (din, dout), b (dout,) zeros)] per layer."""
    gen = generator(device, seed, _MLP)
    out = {}
    for key, dims in mlp_dims(cfg).items():
        layers = []
        for din, dout in zip(dims[:-1], dims[1:]):
            w = torch.randn((din, dout), generator=gen, device=device)
            layers.append((w.mul_(math.sqrt(2.0 / din)),
                           torch.zeros(dout, device=device)))
        out[key] = layers
    return out


def dense_leaves(m: Dict[str, list]) -> Dict[str, torch.Tensor]:
    """{"bot.0.w": W, "bot.0.b": b, ...} in the order of the MLPs' layers."""
    out = {}
    for key in ("bot", "top"):
        for i, (w, b) in enumerate(m[key]):
            out[f"{key}.{i}.w"] = w
            out[f"{key}.{i}.b"] = b
    return out
