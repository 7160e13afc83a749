"""The DLRM family: the port's sparse train step as the system under test,
``reference.py`` as its plain reference, and what the step's trace counts.

A configuration names its family under ``model``; ``spec.model`` finds this
file by that name.  The system under test is
``param_tpu_torch.models.dlrm.DlrmModel``'s sparse train step
(``make_sparse_adagrad_step`` / ``make_sparse_sgd_step``), built on a group
of ``param_tpu_torch.backend.DistBackend`` across cards.  The benchmark
makes the weights (each table in place, one call a table) and a ring of
distinct batches on the device, and reads the first three steps for
``check.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from port_bench import counts, data, reference

NAME = "dlrm"
CHUNK_ROWS = 1 << 19


def dlrm_config(cfg: dict, traffic: dict):
    """The port's ``DlrmConfig`` for ``cfg``; a configuration this family
    does not run as stated is refused, never run another way."""
    from param_tpu_torch.models.dlrm import DlrmConfig

    if cfg.get("model") != NAME:
        raise ValueError(f"not a DLRM configuration: {cfg.get('model')!r}")
    if (cfg.get("dtype") != "float32" or cfg.get("tf32") is not False
            or cfg.get("arch_interaction") != "dot"):
        raise ValueError("the harness drives f32 DLRM (TF32 off) with dot "
                         "interaction")
    return DlrmConfig(
        num_tables=cfg["num_tables"], rows_per_table=cfg["rows_per_table"],
        emb_dim=cfg["emb_dim"], nnz=cfg["nnz"], dense_dim=cfg["dense_dim"],
        bot_mlp=list(cfg["bot_mlp"]), top_mlp=list(cfg["top_mlp"]),
        batch=traffic["batch"], arch_interaction="dot", dtype=torch.float32)


def reference_readings(cfg: dict, traffic: dict, seed: int, shards: int,
                       device, **fault) -> dict:
    """The plain reference's readings (``reference.readings``)."""
    return reference.readings(cfg, traffic, seed, shards, device, **fault)


def controls(chips: int) -> Dict[str, dict]:
    """What ``calibrate.py`` reads beside the program: the control (every
    product in TF32) and the faults, as keywords of
    :func:`reference_readings`."""
    out = {"control": {"tf32": True}, "half_batch": {"half_batch": True}}
    if chips > 1:
        out["exchange"] = {"local_dense_grads": True}
    return out


def _sumsq(x: torch.Tensor) -> float:
    return float(torch.sum(torch.square(x.double())))


class Program:
    """The port's train step with its parameters, optimizer state and ring
    of batches on one rank."""

    def __init__(self, cell, seed: int, rank: int, world: int, group,
                 device):
        from param_tpu_torch.models.dlrm import DlrmModel

        cfg, traffic = cell.config, cell.traffic
        model_cfg = dlrm_config(cfg, traffic)
        torch.backends.cuda.matmul.allow_tf32 = False  # f32, as configured
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.rank, self.world, self.device = rank, world, device
        self.opt = cfg["optimizer"]
        self.lr = float(cfg["lr"])
        self.eps = float(cfg.get("adagrad_eps", 1e-7))
        acc0 = float(cfg.get("adagrad_initial_accumulator", 0.1))
        self.model = DlrmModel(model_cfg, group=group, device=device)
        tl = cfg["num_tables"] // world
        self.table_ids = list(range(rank * tl, (rank + 1) * tl))
        tables = torch.empty((tl, cfg["rows_per_table"], cfg["emb_dim"]),
                             dtype=torch.float32, device=device)
        for i, t in enumerate(self.table_ids):
            data.fill_table(tables[i], seed, t)
        m = data.mlps(cfg, seed, device)
        self.params = {"tables": tables, "bot": m["bot"], "top": m["top"]}
        for leaf in [tables, *data.dense_leaves(m).values()]:
            leaf.requires_grad_(True)
        if self.opt == "sparse_adagrad":
            self.acc = self.model.init_adagrad_state(self.params, acc0)
            self._step = self.model.make_sparse_adagrad_step(
                self.lr, eps=self.eps, initial_accumulator=acc0)
        elif self.opt == "sparse_sgd":
            self.acc = None
            self._step = self.model.make_sparse_sgd_step(self.lr)
        else:
            raise ValueError(f"unknown optimizer {self.opt!r}")
        self.ring = [data.shard_batch(cfg, traffic, seed, b, rank, world,
                                      device)
                     for b in range(int(traffic["ring"]))]
        self.done = 0

    def step(self) -> torch.Tensor:
        """One train step on the next batch of the ring; its loss."""
        batch = self.ring[self.done % len(self.ring)]
        self.done += 1
        if self.acc is None:
            _, loss = self._step(self.params, *batch)
        else:
            _, _, loss = self._step(self.params, self.acc, *batch)
        return loss

    # ------------------------------------------------------ the readings
    def _leaves(self):
        """(name, current, accumulator or None, initial-value maker) of each
        leaf: this rank's tables, then the MLPs' weights and biases."""
        for i, t in enumerate(self.table_ids):
            yield (f"table.{t}", self.params["tables"][i].detach(),
                   None if self.acc is None else self.acc["tables"][i],
                   lambda t=t: data.table(self.cfg, self.seed, t,
                                          self.device))
        init = data.dense_leaves(data.mlps(self.cfg, self.seed, self.device))
        now = data.dense_leaves(self.params)
        acc = (data.dense_leaves(self.acc) if self.acc is not None
               else dict.fromkeys(now))
        for name, p in now.items():
            yield name, p.detach(), acc[name], lambda name=name: init[name]

    def _read(self, fn: Callable) -> Dict[str, List[float]]:
        out = {}
        with torch.no_grad():
            for name, p, a, p0 in self._leaves():
                p0 = p0()
                total = 0.0
                for s in range(0, p.shape[0], CHUNK_ROWS):
                    rows = slice(s, s + CHUNK_ROWS)
                    total += fn(p0[rows], p[rows],
                                None if a is None else a[rows])
                out[name] = [total]
        return out

    def first_grad_sq(self) -> Dict[str, List[float]]:
        """Each leaf's sum of squares of the first gradient, worked out from
        the state after one step (``check.py``)."""
        def fn(p0, p1, a1):
            g = (p0 - p1) / self.lr
            if a1 is not None:
                g = g * torch.sqrt(a1 + self.eps)
            return _sumsq(g)
        return self._read(fn)

    def change_sq(self) -> Dict[str, List[float]]:
        return self._read(lambda p0, p, a: _sumsq(p - p0))

    def checked_steps(self) -> dict:
        """The first three steps, with the readings ``check.py`` compares."""
        losses = [self.step()]
        grad_sq = self.first_grad_sq()
        losses += [self.step() for _ in range(2)]
        return {"loss": [float(x) for x in losses], "grad_sq": grad_sq,
                "change_sq": self.change_sq()}

    # ------------------------------------------------------ the counters
    def unique_rows(self, batch: int) -> int:
        """Distinct rows of this rank's tables that ring batch ``batch``
        looks up (its ids from every shard of the global batch)."""
        tl = len(self.table_ids)
        E = self.cfg["rows_per_table"]
        parts = [data.shard_ids(self.cfg, self.traffic, self.seed, batch, s,
                                self.world, self.device)
                 [:, self.table_ids[0]:self.table_ids[0] + tl, :]
                 for s in range(self.world)]
        ids = torch.cat(parts).long()
        offs = torch.arange(tl, device=ids.device) * E
        return int(torch.unique((ids + offs[None, :, None]).reshape(-1))
                   .numel())

    def trace_counts(self, batches: List[int]) -> dict:
        """The work the readers divide by, for the traced steps, which ran
        on ring batches ``batches``: FLOPs a step, and the lookup's and the
        row update's bytes over all of them (``counts.py``)."""
        uniq = {b: self.unique_rows(b) for b in set(batches)}
        cfg = self.cfg
        bags = self.traffic["batch"] * len(self.table_ids)
        return {
            "flops_step": counts.step_flops(
                cfg, self.traffic["batch"] // self.world),
            "lookup_bytes": sum(counts.lookup_bytes(
                uniq[b], bags, cfg["nnz"], cfg["emb_dim"]) for b in batches),
            "update_bytes": sum(counts.update_bytes(
                uniq[b], cfg["emb_dim"], self.opt == "sparse_adagrad")
                for b in batches)}
