"""The DLRM-DCNv2 family: the port's sparse train step with the low-rank
cross net, per-feature bag sizes and tables of their own rows as the system
under test, ``reference_dcn.py`` as its plain reference, and what the
step's trace counts.

The system under test is ``param_tpu_torch.models.dlrm.DlrmModel``'s sparse
train step (``make_sparse_adagrad_step`` / ``make_sparse_sgd_step``) with
``arch_interaction="dcn"``, ``num_embeddings_per_feature`` and
``multi_hot_sizes``, on one card: the tables are stored flat, and the
batches' ids are one row of every feature's ids a sample.  The benchmark
makes the weights (each table in place, one call a table) and a ring of
distinct batches on the device (``data_dcn.py``), and reads the first three
steps for ``check.py``.

The first gradient is read from the state after one step.  Under Adagrad
with the accumulator starting at 0, as configured, the accumulator holds
g^2 itself, so |g| is its root and the step's direction gives the sign:
the parameters' own difference carries a rounding of up to ulp(p) / (lr g
/ sqrt(eps)) of g where the update is small, up to ~2e-4 of a leaf at
this cell's size on an H100.  Otherwise it is ``check.py``'s ``(p0 - p1)
/ lr``, times ``sqrt(a1 + eps)`` under Adagrad.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from port_bench import counts, data, data_dcn, reference_dcn, spec

NAME = "dlrm_dcn"
_DLRM = spec.model("dlrm")  # the DLRM family, whose readings this reuses
_sumsq = _DLRM._sumsq


def dlrm_config(cfg: dict, traffic: dict):
    """The port's ``DlrmConfig`` for ``cfg``; a configuration this family
    does not run as stated is refused, never run another way."""
    from param_tpu_torch.models.dlrm import DlrmConfig

    if cfg.get("model") != NAME:
        raise ValueError(f"not a DLRM-DCNv2 configuration: "
                         f"{cfg.get('model')!r}")
    if (cfg.get("dtype") != "float32" or cfg.get("tf32") is not False
            or cfg.get("interaction") != "dcn"):
        raise ValueError("the harness drives f32 DLRM-DCNv2 (TF32 off) with "
                         "the dcn interaction")
    return DlrmConfig(
        emb_dim=cfg["emb_dim"], dense_dim=cfg["dense_dim"],
        bot_mlp=list(cfg["bot_mlp"]), top_mlp=list(cfg["top_mlp"]),
        batch=traffic["batch"], arch_interaction="dcn", dtype=torch.float32,
        num_embeddings_per_feature=list(cfg["rows"]),
        multi_hot_sizes=list(cfg["multi_hot_sizes"]),
        dcn_num_layers=cfg["dcn_num_layers"],
        dcn_low_rank_dim=cfg["dcn_low_rank_dim"])


def cross_flops(cfg: dict, batch: int) -> int:
    """The cross net's GEMMs on ``batch`` rows: a layer's forward is
    (B, F) x (F, r) then (B, r) x (r, F), and its backward four products of
    the same size (the gradients of x, V, the low-rank activation and W),
    so 6 x 2 B F r a layer."""
    return (cfg["dcn_num_layers"] * 6 * 2 * batch * data_dcn.width(cfg)
            * cfg["dcn_low_rank_dim"])


def step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of the dense half of a step on ``batch`` rows: both MLPs
    (``counts.mlp_flops``; the bottom's first layer needs no input
    gradient) and the cross net, forward and backward."""
    dims = data_dcn.mlp_dims(cfg)
    return (counts.mlp_flops(dims["bot"], batch, input_grad=False)
            + counts.mlp_flops(dims["top"], batch, input_grad=True)
            + cross_flops(cfg, batch))


def reference_readings(cfg: dict, traffic: dict, seed: int, shards: int,
                       device, **fault) -> dict:
    """The plain reference's readings (``reference_dcn.readings``)."""
    return reference_dcn.readings(cfg, traffic, seed, shards, device,
                                  **fault)


def controls(chips: int) -> Dict[str, dict]:
    """What ``calibrate.py`` reads beside the program: the control (every
    product in TF32) and the fault, as keywords of
    :func:`reference_readings`."""
    return {"control": {"tf32": True}, "half_batch": {"half_batch": True}}


class Program(_DLRM.Program):
    """The port's train step with its parameters, optimizer state and ring
    of batches on one card; the step, the checked steps and the reading of
    the change are the DLRM family's."""

    def __init__(self, cell, seed: int, rank: int, world: int, group,
                 device):
        from param_tpu_torch.models.dlrm import DlrmModel

        cfg, traffic = cell.config, cell.traffic
        model_cfg = dlrm_config(cfg, traffic)
        if world != 1:
            raise ValueError("DLRM-DCNv2's tables of unequal rows run on one "
                             "card")
        torch.backends.cuda.matmul.allow_tf32 = False  # f32, as configured
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.opt = cfg["optimizer"]
        self.lr = float(cfg["lr"])
        self.eps = float(cfg["adagrad_eps"])
        acc0 = float(cfg["adagrad_initial_accumulator"])
        self.acc0 = acc0
        self.model = DlrmModel(model_cfg, group=group, device=device)
        self.starts = data_dcn.row_starts(cfg)
        tables = torch.empty((sum(cfg["rows"]), cfg["emb_dim"]),
                             dtype=torch.float32, device=device)
        for t, (s, n) in enumerate(zip(self.starts, cfg["rows"])):
            data.fill_table(tables[s:s + n], seed, t)
        m = data_dcn.dense_params(cfg, seed, device)
        self.params = {"tables": tables, **m}
        for leaf in [tables, *data_dcn.dense_leaves(m).values()]:
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
        self.ring = [data_dcn.shard_batch(cfg, traffic, seed, b, 0, 1, device)
                     for b in range(int(traffic["ring"]))]
        self.done = 0

    # ------------------------------------------------------ the readings
    def _leaves(self):
        """(name, current, accumulator or None, initial-value maker) of each
        leaf: each table's rows of the flat tables, then the dense
        layers'."""
        tables = self.params["tables"].detach()
        for t, (s, n) in enumerate(zip(self.starts, self.cfg["rows"])):
            yield (f"table.{t}", tables[s:s + n],
                   None if self.acc is None else self.acc["tables"][s:s + n],
                   lambda t=t: data_dcn.table(self.cfg, self.seed, t,
                                              self.device))
        init = data_dcn.dense_leaves(data_dcn.dense_params(
            self.cfg, self.seed, self.device))
        now = data_dcn.dense_leaves(self.params)
        acc = (data_dcn.dense_leaves(self.acc) if self.acc is not None
               else dict.fromkeys(now))
        for name, p in now.items():
            yield name, p.detach(), acc[name], lambda name=name: init[name]

    def first_grad_sq(self) -> Dict[str, List[float]]:
        """Each leaf's sum of squares of the first gradient, worked out from
        the state after one step (``check.py``)."""
        def fn(p0, p1, a1):
            if a1 is not None and self.acc0 == 0.0:
                return _sumsq(torch.sign(p0 - p1) * torch.sqrt(a1))
            g = (p0 - p1) / self.lr
            if a1 is not None:
                g = g * torch.sqrt(a1 + self.eps)
            return _sumsq(g)
        return self._read(fn)

    # ------------------------------------------------------ the counters
    def unique_rows(self, batch: int) -> int:
        """Distinct rows of the flat tables that ring batch ``batch`` looks
        up: each feature's ids plus its table's first row."""
        ids = data_dcn.shard_ids(self.cfg, self.traffic, self.seed, batch, 0,
                                 1, self.device).long()
        offs = torch.repeat_interleave(
            torch.tensor(self.starts, device=ids.device),
            torch.tensor(self.cfg["multi_hot_sizes"], device=ids.device))
        return int(torch.unique(ids + offs).numel())

    def trace_counts(self, batches: List[int]) -> dict:
        """The work the readers divide by, for the traced steps, which ran
        on ring batches ``batches``: FLOPs a step, of the dense half and of
        the cross net alone, and the lookup's and the row update's bytes
        over all of them (``counts.py``; the lookup's ids are the B x L
        real ones, where ``counts.lookup_bytes`` counts one nnz a bag)."""
        cfg, batch = self.cfg, self.traffic["batch"]
        uniq = {b: self.unique_rows(b) for b in set(batches)}
        bags, ids = batch * len(cfg["rows"]), batch * sum(cfg["multi_hot_sizes"])
        return {"flops_step": step_flops(cfg, batch),
                "cross_flops": cross_flops(cfg, batch),
                "lookup_bytes": sum(counts.lookup_bytes(
                    uniq[b], bags, 0, cfg["emb_dim"]) + 4 * ids
                    for b in batches),
                "update_bytes": sum(counts.update_bytes(
                    uniq[b], cfg["emb_dim"], self.opt == "sparse_adagrad")
                    for b in batches)}
