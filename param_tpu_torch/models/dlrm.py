"""DLRM: forward, loss, dense and sparse train steps on one device, or
table-wise sharded over a ``torch.distributed`` group (port of
``param_tpu/models/dlrm.py``).

Parameters are a plain dict in the reference's layout::

    {"tables": (T, E, D), "bot": [(W (din, dout), b), ...], "top": [...]}

and every step updates them IN PLACE and returns them (the reference's jitted
steps return new, donated arrays).

The embedding lookup of all tables is one K1 launch over the flat (T*E, D)
view of the stacked tables, with each table's ids offset by t*E.  The
sparse steps take the pooled-embedding gradient from autograd on a
detached ``pooled`` tensor (the reference's ``jax.vjp`` of the dense half),
segment-sum duplicate rows (:func:`dedup_row_updates`) and apply one K2
launch to the flat table view.

Built with a group (a :class:`~param_tpu_torch.backend.base.CommGroup` of
n ranks), the model is the reference's hybrid-parallel one: rank r holds
tables [r*T/n, (r+1)*T/n) and batch rows [r*B/n, (r+1)*B/n), the MLPs are
replicated, and each step runs the DLRM butterfly on the group:

====  ==========================================  ==========================
comm  reference                                   here
====  ==========================================  ==========================
1/2   ``lax.all_to_all`` of the (B/n, T, nnz)     :func:`all_to_all_tables`
      ids, split on tables, stacked on the batch  (``all_to_all_single``)
3     ``lax.all_to_all`` of the pooled            :class:`PooledAllToAll`,
      (B, T/n, D), split on the batch             :func:`all_to_all_rows`
5     its transpose, from JAX's AD                the Function's backward
4/6   ``lax.pmean`` of the dense gradients        one ``all_reduce`` per MLP
====  ==========================================  ==========================

As in the reference, each rank differentiates its LOCAL mean loss: the
dense gradients are then averaged over the ranks, and the table gradients,
which the pooled exchange's transpose sums over the n ranks, are scaled by
1/n.  The returned loss is the mean over the ranks.  A sharded model runs
its collectives in a world of one too.  Without a group the model is the
single-device one and runs no collective.  The reference's lane-packed
table storage (``packed_tables``) is a TPU layout, and its ``table_update``
choice is the device's here (K2 on the card, its plain version on the CPU):
neither is ported.

While a ``torch.profiler`` runs, the sparse steps record spans and counters
(:func:`~param_tpu_torch.utils.profiler.annotate`) that tile the step:
``dlrm.step`` holds ``dlrm.exchange`` (each collective issued here with a
group), ``dlrm.lookup`` (K1), ``dlrm.dense_fwd`` (its child
``dlrm.interaction``), ``dlrm.dense_bwd`` (the interaction's backward, a
second ``dlrm.interaction``), ``dlrm.dense_update``, ``dlrm.dedup`` (the
pooled gradient expanded to one row a lookup, then
:func:`dedup_row_updates`) and ``dlrm.row_update`` (K2).  Counters:
``dlrm.lookups`` (ids looked up) and ``dlrm.unique_rows`` (the dedup's
runs).  Without a profiler they do nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from param_tpu_torch.models.parallel import all_reduce_mean
from param_tpu_torch.ops.embedding import embedding_bag
from param_tpu_torch.ops.mlp import (
    Adagrad, Sgd, init_mlp, mlp_forward, tree_leaves, tree_map,
)
from param_tpu_torch.ops.sparse_update import dedup_row_updates, sparse_row_update
from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.profiler import annotate, annotate_backward, count


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
    with annotate("dlrm.interaction"):
        z = torch.cat([bot_out[:, None, :], pooled], dim=1)  # (B, m, D)
        zz = torch.bmm(z, z.transpose(1, 2))
        m = z.shape[1]
        li, lj = torch.tril_indices(m, m, offset=-1, device=z.device)
        out = torch.cat([bot_out, zz[:, li, lj]], dim=1)
    annotate_backward("dlrm.interaction", out, z)
    return out


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




# ------------------------------------------------------------ collectives
def all_to_all_tables(x: torch.Tensor, pg, n: int) -> torch.Tensor:
    """(b, T, ...) -> (n*b, T/n, ...): rank j receives table block j of
    every rank, stacked on the batch axis in (source rank, local row)
    order; ``lax.all_to_all(x, split_axis=1, concat_axis=0, tiled=True)``.
    The ids' exchange (comms 1/2) and the pooled exchange's transpose."""
    b, T = x.shape[:2]
    rest = x.shape[2:]
    send = x.reshape(b, n, T // n, *rest).transpose(0, 1).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=pg)
    return out.reshape(n * b, T // n, *rest)


def all_to_all_rows(x: torch.Tensor, pg, n: int) -> torch.Tensor:
    """(n*b, T/n, ...) -> (b, T, ...): rank j receives row block j of every
    rank, concatenated on the table axis in source-rank order;
    ``lax.all_to_all(x, split_axis=0, concat_axis=1, tiled=True)``.  The
    transpose of :func:`all_to_all_tables`."""
    B, Tl = x.shape[:2]
    rest = x.shape[2:]
    send = x.contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=pg)
    return out.reshape(n, B // n, Tl, *rest).transpose(0, 1).reshape(
        B // n, n * Tl, *rest)


class PooledAllToAll(torch.autograd.Function):
    """The pooled-embedding exchange (comm 3) whose backward is the
    transposed exchange (comm 5), as the PyTorch reference's
    ``All2Allv_Req`` / ``All2Allv_Wait`` pair: (B, T/n, D) -> (B/n, T, D)."""

    @staticmethod
    def forward(ctx, pooled_local, pg, n):
        ctx.pg, ctx.n = pg, n
        return all_to_all_rows(pooled_local, pg, n)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_tables(g, ctx.pg, ctx.n), None, None


class DlrmModel:
    """DLRM forward and train steps on one device, or table-wise sharded
    over ``group`` (see the module notes)."""

    def __init__(self, cfg: DlrmConfig, group=None, device="cuda"):
        self.cfg = cfg
        self.group = group
        self.n = 1 if group is None else group.size
        if group is not None and (cfg.num_tables % self.n
                                  or cfg.batch % self.n):
            raise ValueError(
                f"num_tables={cfg.num_tables} and batch={cfg.batch} must "
                f"divide the mesh size {self.n}")
        self.device = resolve_device(device)
        self.local_tables = cfg.num_tables // self.n
        self.local_batch = cfg.batch // self.n
        self.rank = 0 if group is None else dist.get_rank(group.pg)

    def init_params(self, seed: int = 0):
        """The full parameters from ``seed`` (:func:`init_dlrm_params`), of
        which a sharded model keeps its table shard: every world size
        starts from the same numbers."""
        params = init_dlrm_params(seed, self.cfg, self.device)
        if self.group is not None:
            r, tl = self.rank, self.local_tables
            params["tables"] = params["tables"][r * tl:(r + 1) * tl].clone()
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return params

    def place_batch(self, batch):
        """numpy arrays of the global batch, e.g. (dense, idx, labels) ->
        this rank's rows as tensors on the model's device (integer arrays as
        int32)."""
        r, b = self.rank, self.local_batch
        rows = slice(None) if self.group is None else slice(r * b, (r + 1) * b)
        out = []
        for a in batch:
            a = np.asarray(a)
            if a.dtype.kind in "iu":
                a = a.astype(np.int32)
            out.append(torch.tensor(a[rows], device=self.device))
        return tuple(out)

    # ------------------------------------------------------- the butterfly
    def _exchange_ids(self, idx):
        """Comms 1/2: this rank's (b, T, nnz) ids -> (B, T/n, nnz) ids of
        its tables (the identity without a group)."""
        if self.group is None:
            return idx
        with annotate("dlrm.exchange"):
            return all_to_all_tables(idx, self.group.pg, self.n)

    def _exchange_pooled(self, pooled_local):
        """Comm 3 (and 5 in the backward): (B, T/n, D) -> (b, T, D)."""
        if self.group is None:
            return pooled_local
        with annotate("dlrm.exchange"):
            return PooledAllToAll.apply(pooled_local, self.group.pg, self.n)

    def mean_over_ranks(self, tensors):
        """Comms 4/6: the mean over the group of each tensor."""
        with annotate("dlrm.exchange"):
            return all_reduce_mean(tensors, self.group.pg, self.n)

    def _mean_loss(self, loss):
        if self.group is None:
            return loss.detach()
        return self.mean_over_ranks([loss.detach()])[0]

    def _mean_dense_grads(self, mlps, g_mlps):
        """The dense gradients (leaves of ``mlps``, bottom MLP first)
        averaged over the group: the top MLP's all-reduce, then the
        bottom's, as the backward reaches them."""
        nb = len(tree_leaves(mlps["bot"]))
        top = self.mean_over_ranks(g_mlps[nb:])
        return self.mean_over_ranks(g_mlps[:nb]) + top

    def forward(self, params, dense, idx):
        """Logits of this rank's rows."""
        pooled = _lookup_local_tables(params["tables"], self._exchange_ids(idx))
        return _forward_local(params, self.cfg, dense,
                              self._exchange_pooled(pooled))

    def loss_fn(self, params, dense, idx, labels):
        """Mean loss over this rank's rows (differentiable)."""
        return _bce(self.forward(params, dense, idx), labels)

    def make_sharded_loss(self):
        """``loss(params, dense, idx, labels)``: the loss of the global
        batch, the mean over the ranks of their local losses."""

        def loss(params, dense, idx, labels):
            with torch.no_grad():
                return self._mean_loss(self.loss_fn(params, dense, idx,
                                                    labels))

        return loss

    def make_sharded_loss_ragged(self, wire: str = "padded"):
        """``loss(params, dense, lengths, idx_padded, labels)`` with ragged
        bags: ids beyond a bag's length are ignored, and the ids reach
        their tables' owners by :func:`~param_tpu_torch.models.ragged.
        ragged_sparse_dist` over ``wire``.  Each table carries one extra
        zero pad row: ``params["tables"]`` is (T/n, E + 1, D)."""
        from param_tpu_torch.models.ragged import ragged_sparse_dist

        if self.group is None:
            raise ValueError("the ragged exchange runs over a group")
        cfg = self.cfg

        def loss(params, dense, lengths, idx_padded, labels):
            with torch.no_grad():
                _, idx_t = ragged_sparse_dist(
                    lengths, idx_padded, self.group,
                    pad_row=cfg.rows_per_table, wire=wire)
                pooled = _lookup_local_tables(params["tables"], idx_t)
                logits = _forward_local(params, cfg, dense,
                                        self._exchange_pooled(pooled))
                return self._mean_loss(_bce(logits, labels))

        return loss

    def _value_and_grad(self, params, dense, idx, labels):
        """(loss of the global batch, gradient tree of that loss)."""
        loss = self.loss_fn(params, dense, idx, labels)
        grads = _rebuild(params, torch.autograd.grad(loss,
                                                     tree_leaves(params)))
        if self.group is not None:
            g_mlps = {"bot": grads["bot"], "top": grads["top"]}
            g_mlps = _rebuild(g_mlps, self._mean_dense_grads(
                g_mlps, tree_leaves(g_mlps)))
            grads = {**grads, **g_mlps,
                     "tables": grads["tables"] * (1.0 / self.n)}
        return self._mean_loss(loss), grads

    def make_value_and_grad(self):
        """``vg(params, dense, idx, labels) -> (loss, grads)``: the
        gradients of the global batch's loss, dense ones averaged over the
        group, table ones for this rank's shard."""
        return self._value_and_grad

    def make_train_step(self, optimizer):
        """Dense step: autograd over every parameter (the tables get a dense
        table-shaped gradient), then ``optimizer.update`` in place.
        ``step(params, opt_state, dense, idx, labels) -> (params, opt_state,
        loss)``."""

        def step(params, opt_state, dense, idx, labels):
            loss, grads = self._value_and_grad(params, dense, idx, labels)
            opt_state = optimizer.update(params, tree_leaves(grads),
                                         opt_state)
            return params, opt_state, loss

        return step

    def _sparse_fwd_bwd(self, params, dense, idx, labels):
        """Forward plus the backward of the dense half.  Returns (loss, this
        rank's tables' ids (B, T/n, nnz), the pooled gradient (B, T/n, D),
        the dense layers ``{"bot", "top"}``, their gradients)."""
        cfg = self.cfg
        idx_t = self._exchange_ids(idx)
        count("dlrm.lookups", idx_t.numel())
        with annotate("dlrm.lookup"), torch.no_grad():
            pooled = _lookup_local_tables(params["tables"], idx_t)
        pooled = pooled.detach().requires_grad_(True)
        mlps = {"bot": params["bot"], "top": params["top"]}
        pooled_all = self._exchange_pooled(pooled)
        with annotate("dlrm.dense_fwd"):
            loss = _bce(_forward_local(params, cfg, dense, pooled_all), labels)
        with annotate("dlrm.dense_bwd"):
            g_pooled, *g_mlps = torch.autograd.grad(
                loss, [pooled] + tree_leaves(mlps))
        if self.group is not None:
            g_mlps = self._mean_dense_grads(mlps, g_mlps)
        return self._mean_loss(loss), idx_t, g_pooled, mlps, g_mlps

    def _row_updates(self, idx_t, g_pooled, scale=None):
        """The dedup: one gradient row a lookup, in the flat view of this
        rank's tables, ordered table-major as the reference's
        ``_gather_row_updates`` orders them (times ``scale`` where given),
        then segment-summed by row (:func:`dedup_row_updates`)."""
        cfg = self.cfg
        with annotate("dlrm.dedup"), torch.no_grad():
            if self.group is not None:
                g_pooled = g_pooled * (1.0 / self.n)
            gidx = _global_ids(idx_t, cfg.rows_per_table).transpose(0, 1) \
                .reshape(-1)
            rows_g = g_pooled.transpose(0, 1).repeat_interleave(
                idx_t.shape[2], dim=1).reshape(-1, cfg.emb_dim)
            if scale is not None:
                rows_g = scale * rows_g
            return dedup_row_updates(gidx, rows_g,
                                     self.local_tables * cfg.rows_per_table)

    def make_sparse_sgd_step(self, lr: float = 0.01):
        """Sparse SGD: only the gathered table rows change, by a K2 launch
        with the deduplicated ``-lr * g`` rows; dense layers take plain SGD.
        ``step(params, dense, idx, labels) -> (params, loss)``."""
        R = self.local_tables * self.cfg.rows_per_table
        sgd = Sgd(lr)

        def step(params, dense, idx, labels):
            with annotate("dlrm.step"):
                loss, idx_t, g_pooled, mlps, g_mlps = self._sparse_fwd_bwd(
                    params, dense, idx, labels)
                with annotate("dlrm.dense_update"):
                    sgd.update(mlps, g_mlps, None)
                rows, totals = self._row_updates(idx_t, g_pooled, -lr)
                with annotate("dlrm.row_update"), torch.no_grad():
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
        R = self.local_tables * self.cfg.rows_per_table
        adagrad = Adagrad(lr, initial_accumulator, eps)

        def step(params, acc, dense, idx, labels):
            with annotate("dlrm.step"):
                loss, idx_t, g_pooled, mlps, g_mlps = self._sparse_fwd_bwd(
                    params, dense, idx, labels)
                with annotate("dlrm.dense_update"):
                    adagrad.update(mlps, g_mlps,
                                   {"bot": acc["bot"], "top": acc["top"]})
                rows, totals = self._row_updates(idx_t, g_pooled)
                with annotate("dlrm.row_update"), torch.no_grad():
                    sparse_row_update(params["tables"].detach().view(R, -1),
                                      rows, totals, acc["tables"].view(R, -1),
                                      lr=lr, eps=eps)
            return params, acc, loss

        return step

    def init_adagrad_state(self, params, initial_accumulator: float = 0.1):
        """Accumulator tree matching ``params``, filled with
        ``initial_accumulator``."""
        return tree_map(lambda p: torch.full_like(p.detach(), initial_accumulator),
                        params)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (e.g. its logits), in global batch
        order (``x`` itself without a group)."""
        if self.group is None:
            return x
        x = x.contiguous()
        out = x.new_empty((self.n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group.pg)
        return out


def _rebuild(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
