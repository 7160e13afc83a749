"""DLRM on one device: forward, loss, dense and sparse train steps (port of
``param_tpu/models/dlrm.py``).

Parameters are a plain dict in the reference's layout::

    {"tables": (T, E, D), "bot": [(W (din, dout), b), ...], "top": [...]}

and every step updates them IN PLACE and returns them (the reference's jitted
steps return new, donated arrays).

The embedding lookup of all T tables is one K1 launch over the flat
(T*E, D) view of the stacked tables, with each table's ids offset by t*E.
The sparse steps take the pooled-embedding gradient from autograd on a
detached ``pooled`` tensor (the reference's ``jax.vjp`` of the dense half),
segment-sum duplicate rows (:func:`dedup_row_updates`) and apply one K2
launch to the flat table view.

With one device every all-to-all of the reference's sharded step is the
identity, so this module has no collectives; a world size above 1 raises.
The reference's lane-packed table storage (``packed_tables``) is a TPU
layout and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from param_tpu_torch.ops.embedding import embedding_bag
from param_tpu_torch.ops.mlp import (
    Adagrad, Sgd, init_mlp, mlp_forward, tree_leaves, tree_map,
)
from param_tpu_torch.ops.sparse_update import dedup_row_updates, sparse_row_update
from param_tpu_torch.utils.device import resolve_device

_SHARDED = ("sharded DLRM (world size > 1) is ROADMAP queue 1 item 7, "
            "not ported yet")


@dataclass
class DlrmConfig:
    """Model dimensions (same fields and defaults as the reference)."""

    num_tables: int = 8
    rows_per_table: int = 100_000
    emb_dim: int = 64
    nnz: int = 10
    dense_dim: int = 64
    bot_mlp: List[int] = field(default_factory=lambda: [512, 256, 64])
    top_mlp: List[int] = field(default_factory=lambda: [512, 256, 1])
    batch: int = 2048
    arch_interaction: str = "dot"  # dot | cat
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.bot_mlp[-1] != self.emb_dim:
            raise ValueError(
                f"bot MLP output {self.bot_mlp[-1]} must equal emb_dim {self.emb_dim}"
            )

    @property
    def num_sparse_plus_dense(self) -> int:
        return self.num_tables + 1

    @property
    def interaction_dim(self) -> int:
        m = self.num_sparse_plus_dense
        if self.arch_interaction == "dot":
            return self.emb_dim + m * (m - 1) // 2
        return m * self.emb_dim

    def top_mlp_dims(self) -> List[int]:
        return [self.interaction_dim] + list(self.top_mlp)

    def bot_mlp_dims(self) -> List[int]:
        return [self.dense_dim] + list(self.bot_mlp)


def init_dlrm_params(seed: int, cfg: DlrmConfig, device="cuda") -> Dict[str, Any]:
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``;
    the numbers differ from the reference's ``jax.random`` ones).  Tables are
    N(0, 1/E), MLPs He-initialised."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    T, E, D = cfg.num_tables, cfg.rows_per_table, cfg.emb_dim
    tables = torch.randn((T, E, D), generator=gen, dtype=cfg.dtype,
                         device=dev) / float(np.sqrt(E))
    return {
        "tables": tables,
        "bot": init_mlp(gen, cfg.bot_mlp_dims(), cfg.dtype, dev),
        "top": init_mlp(gen, cfg.top_mlp_dims(), cfg.dtype, dev),
    }


def dot_interaction(bot_out: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Pairwise-dot feature interaction.

    bot_out (B, D); pooled (B, T, D) -> (B, D + (T+1)T/2).  Pairs are the
    strict lower triangle in row-major order, as ``jnp.tril_indices(m,
    k=-1)`` gives them."""
    z = torch.cat([bot_out[:, None, :], pooled], dim=1)  # (B, m, D)
    zz = torch.bmm(z, z.transpose(1, 2))
    m = z.shape[1]
    li, lj = torch.tril_indices(m, m, offset=-1, device=z.device)
    return torch.cat([bot_out, zz[:, li, lj]], dim=1)


def _forward_local(params, cfg: DlrmConfig, dense, pooled_all):
    """Dense half of the model: bottom MLP, interaction, top MLP -> (b,)."""
    bot_out = mlp_forward(params["bot"], dense)
    if cfg.arch_interaction == "dot":
        feat = dot_interaction(bot_out, pooled_all)
    else:
        feat = torch.cat([bot_out, pooled_all.reshape(pooled_all.shape[0], -1)],
                         dim=1)
    return mlp_forward(params["top"], feat)[:, 0]


def _global_ids(idx_full: torch.Tensor, rows_per_table: int) -> torch.Tensor:
    """(B, T, nnz) per-table ids -> the same ids in the flat (T*E, D) view."""
    T = idx_full.shape[1]
    offs = torch.arange(T, dtype=torch.int32, device=idx_full.device)
    return idx_full + (offs * rows_per_table)[None, :, None]


def _lookup_local_tables(local_tables: torch.Tensor, idx_full: torch.Tensor):
    """Pooled lookup of every table: (T, E, D), (B, T, nnz) -> (B, T, D).

    One K1 launch over the flat (T*E, D) view with the B*T bags of all
    tables, instead of one launch per table."""
    T, E, D = local_tables.shape
    if T * E >= 2**31:
        raise ValueError(f"{T} x {E} rows do not fit int32 row ids")
    B, _, nnz = idx_full.shape
    gidx = _global_ids(idx_full, E).reshape(B * T, nnz)
    out = embedding_bag(local_tables.reshape(T * E, D), gidx)
    return out.reshape(B, T, D)


def _bce(logits, labels):
    """Numerically stable mean binary cross-entropy on logits."""
    return torch.mean(torch.relu(logits) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class DlrmModel:
    """Single-device DLRM forward and train steps."""

    def __init__(self, cfg: DlrmConfig, world_size: int = 1, device="cuda"):
        if world_size != 1:
            raise NotImplementedError(_SHARDED)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed: int = 0):
        params = init_dlrm_params(seed, self.cfg, self.device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params

    def place_batch(self, batch):
        """numpy (dense, idx, labels) -> tensors on the model's device."""
        dense, idx, labels = batch
        dev = self.device
        return (torch.tensor(np.asarray(dense), device=dev),
                torch.tensor(np.asarray(idx, dtype=np.int32), device=dev),
                torch.tensor(np.asarray(labels), device=dev))

    def forward(self, params, dense, idx):
        pooled = _lookup_local_tables(params["tables"], idx)
        return _forward_local(params, self.cfg, dense, pooled)

    def loss_fn(self, params, dense, idx, labels):
        return _bce(self.forward(params, dense, idx), labels)

    def make_train_step(self, optimizer):
        """Dense step: autograd over every parameter (the tables get a dense
        (T, E, D) gradient), then ``optimizer.update`` in place.
        ``step(params, opt_state, dense, idx, labels) -> (params, opt_state,
        loss)``."""

        def step(params, opt_state, dense, idx, labels):
            leaves = tree_leaves(params)
            loss = self.loss_fn(params, dense, idx, labels)
            grads = torch.autograd.grad(loss, leaves)
            opt_state = optimizer.update(params, grads, opt_state)
            return params, opt_state, loss.detach()

        return step

    def _sparse_fwd_bwd(self, params, dense, idx, labels):
        """Forward plus the backward of the dense half.  Returns (loss,
        per-occurrence row ids (K,) in the flat table view, their gradients
        (K, D), the dense layers ``{"bot", "top"}``, their gradients).

        Ids and gradients are ordered table-major, as the reference's
        ``_gather_row_updates`` orders them."""
        cfg = self.cfg
        with torch.no_grad():
            pooled = _lookup_local_tables(params["tables"], idx)
        pooled = pooled.detach().requires_grad_(True)
        mlps = {"bot": params["bot"], "top": params["top"]}
        loss = _bce(_forward_local(params, cfg, dense, pooled), labels)
        g_pooled, *g_mlps = torch.autograd.grad(
            loss, [pooled] + tree_leaves(mlps))  # g_pooled (B, T, D)
        nnz = idx.shape[2]
        gidx = _global_ids(idx, cfg.rows_per_table).transpose(0, 1).reshape(-1)
        rows_g = g_pooled.transpose(0, 1).repeat_interleave(nnz, dim=1)
        return (loss.detach(), gidx, rows_g.reshape(-1, cfg.emb_dim), mlps,
                g_mlps)

    def make_sparse_sgd_step(self, lr: float = 0.01):
        """Sparse SGD: only the gathered table rows change, by a K2 launch
        with the deduplicated ``-lr * g`` rows; dense layers take plain SGD.
        ``step(params, dense, idx, labels) -> (params, loss)``."""
        R = self.cfg.num_tables * self.cfg.rows_per_table
        sgd = Sgd(lr)

        def step(params, dense, idx, labels):
            loss, gidx, rows_g, mlps, g_mlps = self._sparse_fwd_bwd(
                params, dense, idx, labels)
            sgd.update(mlps, g_mlps, None)
            with torch.no_grad():
                rows, totals = dedup_row_updates(gidx, -lr * rows_g, R)
                tables = params["tables"]
                sparse_row_update(tables.detach().view(R, -1), rows,
                                  totals.to(tables.dtype))
            return params, loss

        return step

    def make_sparse_adagrad_step(self, lr: float = 0.01, eps: float = 1e-7,
                                 initial_accumulator: float = 0.1):
        """Sparse Adagrad with optax ``scale_by_rss`` semantics: duplicate
        row gradients are segment-summed before squaring, then one K2 launch
        updates the touched rows of the table and its accumulator; dense
        layers take dense Adagrad.  ``initial_accumulator`` only documents
        the state :meth:`init_adagrad_state` made.
        ``step(params, acc, dense, idx, labels) -> (params, acc, loss)``."""
        R = self.cfg.num_tables * self.cfg.rows_per_table
        adagrad = Adagrad(lr, initial_accumulator, eps)

        def step(params, acc, dense, idx, labels):
            loss, gidx, rows_g, mlps, g_mlps = self._sparse_fwd_bwd(
                params, dense, idx, labels)
            adagrad.update(mlps, g_mlps, {"bot": acc["bot"], "top": acc["top"]})
            with torch.no_grad():
                rows, totals = dedup_row_updates(gidx, rows_g, R)
                sparse_row_update(params["tables"].detach().view(R, -1), rows,
                                  totals, acc["tables"].view(R, -1),
                                  lr=lr, eps=eps)
            return params, acc, loss

        return step

    def init_adagrad_state(self, params, initial_accumulator: float = 0.1):
        """Accumulator tree matching ``params``, filled with
        ``initial_accumulator``."""
        return tree_map(lambda p: torch.full_like(p.detach(), initial_accumulator),
                        params)
