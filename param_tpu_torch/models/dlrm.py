"""DLRM: forward, loss, dense and sparse train steps on one device, or
table-wise sharded over a ``torch.distributed`` group (port of
``param_tpu/models/dlrm.py``).

Parameters are a plain dict in the reference's layout::

    {"tables": (T, E, D), "bot": [(W (din, dout), b), ...], "top": [...]}

and every step updates them IN PLACE and returns them (the reference's jitted
steps return new, donated arrays).

The embedding lookup of all tables is one K1 launch over the flat (T*E, D)
view of the stacked tables, with each table's ids offset by t*E.  The
dot interaction is one kernel each way on the card
(:class:`_DotInteraction`, ``kernels/interaction.py``).  The sparse steps
take the pooled-embedding gradient from autograd on a detached
``pooled`` tensor (the reference's ``jax.vjp`` of the dense half),
segment-sum it by row id (:func:`dedup_sum`: each lookup's row is its
bag's row of the pooled gradient) and apply one K2 launch to the flat table
view.

DLRM-DCNv2 (torchrec's ``dlrm_main.py``, MLPerf's recommender) widens
this on one device, each by an argument named as that script names it:
``num_embeddings_per_feature`` gives each table its own rows, and the
tables are then stored flat, ``"tables"`` (sum of rows, D), each table's
ids offset by the rows before it; ``multi_hot_sizes`` gives each feature
its own bag size, and a batch's ids are then (B, L), one row of L = their
sum a sample, feature t's bag the t-th slice of it (K1's and the dedup's
per-feature layout: no pad slot); ``arch_interaction="dcn"`` puts the
low-rank cross net (``dcn_num_layers`` layers of rank
``dcn_low_rank_dim``) in place of the dot, its layers under ``"cross"``,
[(V (F, r), W (r, F), b (F,)), ...], dense leaves like the MLPs'.  Equal
rows and sizes keep the (T, E, D) tables and (B, T, nnz) ids above; any
other model looks up and deduplicates in the per-feature layout, which
reads a (B, T, nnz) batch of tables of their own rows as (B, T * nnz).

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
second ``dlrm.interaction``), ``dlrm.dense_update``, ``dlrm.dedup``
(:func:`dedup_sum`) and ``dlrm.row_update`` (K2); under each DCN
``dlrm.interaction``, one ``dlrm.cross`` a cross layer.  Counters:
``dlrm.lookups`` (ids looked up), ``dlrm.bags`` (bags looked up),
``dlrm.unique_rows`` (the dedup's runs), ``dlrm.dedup_carried_runs``
(runs that cross the end of one of the dedup kernel's chunks) and
``dlrm.interaction_rows`` (samples through the dot interaction's forward
kernel).  Without a profiler they do nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from param_tpu_torch.kernels.interaction import (
    dot_interaction_bwd_plain, dot_interaction_plain,
)
from param_tpu_torch.models.parallel import all_reduce_mean
from param_tpu_torch.ops.embedding import embedding_bag
from param_tpu_torch.ops.mlp import (
    Adagrad, Sgd, init_mlp, mlp_forward, tree_leaves, tree_map,
)
from param_tpu_torch.ops.sparse_update import dedup_sum, sparse_row_update
from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.profiler import annotate, annotate_backward, count


@dataclass
class DlrmConfig:
    """Model dimensions (same fields and defaults as the reference), and
    DLRM-DCNv2's arguments under ``dlrm_main.py``'s names (module notes).
    Where ``num_embeddings_per_feature`` or ``multi_hot_sizes`` is given it
    sets ``num_tables``; equal entries set ``rows_per_table`` / ``nnz``."""

    num_tables: int = 8
    rows_per_table: int = 100_000
    emb_dim: int = 64
    nnz: int = 10
    dense_dim: int = 64
    bot_mlp: List[int] = field(default_factory=lambda: [512, 256, 64])
    top_mlp: List[int] = field(default_factory=lambda: [512, 256, 1])
    batch: int = 2048
    arch_interaction: str = "dot"  # dot | cat | dcn
    dtype: Any = torch.float32
    num_embeddings_per_feature: Optional[List[int]] = None
    multi_hot_sizes: Optional[List[int]] = None
    dcn_num_layers: int = 3
    dcn_low_rank_dim: int = 512

    def __post_init__(self):
        if self.bot_mlp[-1] != self.emb_dim:
            raise ValueError(
                f"bot MLP output {self.bot_mlp[-1]} must equal emb_dim {self.emb_dim}"
            )
        if self.arch_interaction not in ("dot", "cat", "dcn"):
            raise ValueError(f"unknown interaction {self.arch_interaction!r}")
        given = [list(x) for x in (self.num_embeddings_per_feature,
                                   self.multi_hot_sizes) if x is not None]
        if given:
            if len({len(x) for x in given}) != 1 or not given[0]:
                raise ValueError("num_embeddings_per_feature and "
                                 "multi_hot_sizes need one entry a feature")
            self.num_tables = len(given[0])
        for name in ("num_embeddings_per_feature", "multi_hot_sizes"):
            x = getattr(self, name)
            if x is None:
                continue
            x = [int(n) for n in x]
            if min(x) < 1:
                raise ValueError(f"{name} must be positive, got {x}")
            setattr(self, name, x)
            if len(set(x)) == 1:
                if name == "multi_hot_sizes":
                    self.nnz = x[0]
                else:
                    self.rows_per_table = x[0]
        if self.arch_interaction == "dcn" and (self.dcn_num_layers < 0 or
                                               self.dcn_low_rank_dim < 1):
            raise ValueError("the cross net needs layers >= 0 and rank >= 1")

    @property
    def table_rows(self) -> List[int]:
        """Rows of each table."""
        return list(self.num_embeddings_per_feature
                    or [self.rows_per_table] * self.num_tables)

    @property
    def bag_sizes(self) -> List[int]:
        """Ids of each feature's bag."""
        return list(self.multi_hot_sizes or [self.nnz] * self.num_tables)

    @property
    def equal_tables(self) -> bool:
        """Every table has the same rows: stored (T, E, D)."""
        return len(set(self.table_rows)) == 1

    @property
    def fixed_nnz(self) -> bool:
        """Every bag has the same size: ids (B, T, nnz)."""
        return len(set(self.bag_sizes)) == 1

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
    N(0, 1/E) (tables of unequal rows flat, each drawn in place), MLPs
    He-initialised, cross layers Xavier-normal with zero biases
    (:func:`init_cross`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    T, E, D = cfg.num_tables, cfg.rows_per_table, cfg.emb_dim
    if cfg.equal_tables:
        tables = torch.randn((T, E, D), generator=gen, dtype=cfg.dtype,
                             device=dev) / float(np.sqrt(E))
    else:
        rows = cfg.table_rows
        tables = torch.empty((sum(rows), D), dtype=cfg.dtype, device=dev)
        for start, n in zip(np.cumsum([0] + rows[:-1]), rows):
            tables[start:start + n].normal_(0.0, float(n) ** -0.5,
                                            generator=gen)
    params = {
        "tables": tables,
        "bot": init_mlp(gen, cfg.bot_mlp_dims(), cfg.dtype, dev),
        "top": init_mlp(gen, cfg.top_mlp_dims(), cfg.dtype, dev),
    }
    if cfg.arch_interaction == "dcn":
        params["cross"] = init_cross(gen, cfg.interaction_dim,
                                     cfg.dcn_low_rank_dim, cfg.dcn_num_layers,
                                     cfg.dtype, dev)
    return params


def init_cross(generator: torch.Generator, width: int, rank: int,
               layers: int, dtype=torch.float32, device="cuda"):
    """Low-rank cross layers [(V (width, rank), W (rank, width), b
    (width,)), ...]: V and W Xavier-normal (std sqrt(2 / (width + rank)),
    torchrec's ``LowRankCrossNet``), b zero."""
    std = (2.0 / (width + rank)) ** 0.5
    out = []
    for _ in range(layers):
        v = torch.randn((width, rank), generator=generator, dtype=dtype,
                        device=device) * std
        w = torch.randn((rank, width), generator=generator, dtype=dtype,
                        device=device) * std
        out.append((v, w, torch.zeros((width,), dtype=dtype, device=device)))
    return out


class _DotInteraction(torch.autograd.Function):
    """The dot interaction, its backward inside a ``dlrm.interaction``
    span.  On the card it calls the ops ``param_tpu_torch::
    dot_interaction`` / ``::dot_interaction_bwd`` (one kernel each way,
    :mod:`~param_tpu_torch.kernels.interaction`); on the CPU it runs their
    plain versions itself, so that a CPU execution-trace capture holds the
    plain versions' aten ops (their device markers included) and not the
    ops.  It keeps ``bot_out`` and ``pooled``, which the backward reads
    again in place of z."""

    @staticmethod
    def forward(ctx, bot_out, pooled):
        ctx.save_for_backward(bot_out, pooled)
        if bot_out.is_cuda:
            return torch.ops.param_tpu_torch.dot_interaction.default(
                bot_out, pooled)
        return dot_interaction_plain(bot_out, pooled)

    @staticmethod
    def backward(ctx, grad):
        bot_out, pooled = ctx.saved_tensors
        with annotate("dlrm.interaction"):
            if grad.is_cuda:
                return torch.ops.param_tpu_torch.dot_interaction_bwd.default(
                    grad, bot_out, pooled)
            return dot_interaction_bwd_plain(grad, bot_out, pooled)


def dot_interaction(bot_out: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Pairwise-dot feature interaction.

    bot_out (B, D); pooled (B, T, D) -> (B, D + (T+1)T/2).  Pairs are the
    strict lower triangle in row-major order, as ``jnp.tril_indices(m,
    k=-1)`` gives them."""
    with annotate("dlrm.interaction"):
        return _DotInteraction.apply(bot_out, pooled)


class _LowRankCross(torch.autograd.Function):
    """One cross layer, ``x0 * (x V W + b) + x``, in cuBLAS GEMMs and
    elementwise passes, with its backward written out (four GEMMs) inside
    a ``dlrm.cross`` span."""

    @staticmethod
    def forward(ctx, x0, x, v, w, b):
        u = torch.matmul(x, v)  # (B, r)
        h = torch.addmm(b, u, w)  # (B, F)
        ctx.save_for_backward(x0, x, v, w, u, h)
        return torch.addcmul(x, x0, h)

    @staticmethod
    def backward(ctx, gy):
        x0, x, v, w, u, h = ctx.saved_tensors
        with annotate("dlrm.cross"):
            gh = gy * x0
            gu = torch.matmul(gh, w.t())
            gx = torch.addmm(gy, gu, v.t())
            gv = torch.matmul(x.t(), gu)
            gw = torch.matmul(u.t(), gh)
            gb = gh.sum(0)
            gx0 = gy * h
        return gx0, gx, gv, gw, gb


def low_rank_cross(x0: torch.Tensor, x: torch.Tensor, layer) -> torch.Tensor:
    """One layer ``(V, W, b)`` of the low-rank cross net (torchrec's
    ``LowRankCrossNet``): ``x0 * (W (V x) + b) + x`` for each row, with V
    (F, r) and W (r, F) in the MLPs' (din, dout) layout."""
    with annotate("dlrm.cross"):
        return _LowRankCross.apply(x0, x, *layer)


def dcn_interaction(bot_out: torch.Tensor, pooled: torch.Tensor,
                    cross) -> torch.Tensor:
    """DCNv2's interaction: x0 = the bottom output then the pooled
    features, flattened, (B, (T+1) D); then each cross layer in turn.  Its
    backward is a second ``dlrm.interaction``, from a hook on its output
    to one on x0."""
    with annotate("dlrm.interaction"):
        x0 = torch.cat([bot_out, pooled.reshape(pooled.shape[0], -1)], dim=1)
        x = x0
        for layer in cross:
            x = low_rank_cross(x0, x, layer)
    annotate_backward("dlrm.interaction", x, x0)
    return x


def _forward_local(params, cfg: DlrmConfig, dense, pooled_all):
    """Dense half of the model: bottom MLP, interaction, top MLP -> (b,)."""
    bot_out = mlp_forward(params["bot"], dense)
    if cfg.arch_interaction == "dot":
        feat = dot_interaction(bot_out, pooled_all)
    elif cfg.arch_interaction == "dcn":
        feat = dcn_interaction(bot_out, pooled_all, params["cross"])
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
        if group is not None and not cfg.equal_tables:
            raise ValueError(
                "tables of unequal rows run on one device only: sharding "
                "them over ranks is ROADMAP C4's other half, not ported")
        if group is not None and not cfg.fixed_nnz:
            raise ValueError(
                "bags of per-feature sizes run on one device only: their "
                "exchange between ranks is ROADMAP C2's other half, not "
                "ported")
        self.device = resolve_device(device)
        self.local_tables = cfg.num_tables // self.n
        self.local_batch = cfg.batch // self.n
        self.rank = 0 if group is None else dist.get_rank(group.pg)
        rows = cfg.table_rows[self.rank * self.local_tables:
                              (self.rank + 1) * self.local_tables]
        self.local_rows = sum(rows)
        # equal tables and bags keep the (T, E, D) tables and (B, T, nnz)
        # ids; any other model takes the per-feature layout, a (B, T, nnz)
        # batch read as (B, T * nnz), and adds each column's table's first
        # row in the flat view of the tables to its ids
        self._per_feature = not (cfg.equal_tables and cfg.fixed_nnz)
        self._row_offsets = None
        if self._per_feature:
            starts = np.cumsum([0] + rows[:-1])
            self._row_offsets = torch.tensor(
                np.repeat(starts, cfg.bag_sizes), dtype=torch.int32,
                device=self.device)

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

    # ------------------------------------------------------- the lookup
    def _global_ids(self, idx_t: torch.Tensor) -> torch.Tensor:
        """This rank's tables' ids -> rows of the tables' flat (R, D)
        view: equal tables and bags (B, T, nnz) by the module's
        :func:`_global_ids`, the per-feature layout (B, L) each id plus
        its table's first row."""
        if not self._per_feature:
            return _global_ids(idx_t, self.cfg.rows_per_table)
        return idx_t.reshape(idx_t.shape[0], -1) + self._row_offsets

    def _lookup(self, tables: torch.Tensor, idx_t: torch.Tensor
                ) -> torch.Tensor:
        """Pooled lookup of every table of this rank, one K1 launch:
        (B, T, D).  The per-feature layout reads its (B, L) ids, no pad
        slot.  Equal tables and bags take :func:`_lookup_local_tables`,
        which reads the rows a table from ``tables`` (the ragged loss's
        carry a pad row)."""
        if not self._per_feature:
            return _lookup_local_tables(tables, idx_t)
        flat = tables.reshape(-1, tables.shape[-1])
        if flat.shape[0] >= 2**31:
            raise ValueError(f"{flat.shape[0]} rows do not fit int32 row ids")
        out = embedding_bag(flat, self._global_ids(idx_t),
                            bag_sizes=self.cfg.bag_sizes)
        return out.reshape(idx_t.shape[0], -1, flat.shape[1])

    def forward(self, params, dense, idx):
        """Logits of this rank's rows."""
        pooled = self._lookup(params["tables"], self._exchange_ids(idx))
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
                pooled = self._lookup(params["tables"], idx_t)
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
            g_mlps = _dense_part(grads)
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
        count("dlrm.bags", idx_t.shape[0] * self.local_tables)
        with annotate("dlrm.lookup"), torch.no_grad():
            pooled = self._lookup(params["tables"], idx_t)
        pooled = pooled.detach().requires_grad_(True)
        mlps = _dense_part(params)
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
        """The dedup: each lookup's gradient row (its bag's row of
        ``g_pooled``, times ``scale`` where given) segment-summed by row id
        in the flat view of this rank's tables (:func:`dedup_sum`).  The ids
        stay in their (B, T, nnz) order (the per-feature layout: (B, L),
        each lookup's bag read from that layout): a stable sort keeps each id's
        lookups in (b, k) order, as the reference's table-major
        ``_gather_row_updates`` orders them."""
        cfg = self.cfg
        with annotate("dlrm.dedup"), torch.no_grad():
            if self.group is not None:
                g_pooled = g_pooled * (1.0 / self.n)
            gidx = self._global_ids(idx_t)
            g = g_pooled.reshape(-1, cfg.emb_dim).contiguous()
            if not self._per_feature:
                return dedup_sum(gidx.reshape(-1, idx_t.shape[2]), g, scale,
                                 self.local_rows)
            return dedup_sum(gidx, g, scale, self.local_rows, cfg.bag_sizes)

    def make_sparse_sgd_step(self, lr: float = 0.01):
        """Sparse SGD: only the gathered table rows change, by a K2 launch
        with the deduplicated ``-lr * g`` rows; dense layers take plain SGD.
        ``step(params, dense, idx, labels) -> (params, loss)``."""
        R = self.local_rows
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
        R = self.local_rows
        adagrad = Adagrad(lr, initial_accumulator, eps)

        def step(params, acc, dense, idx, labels):
            with annotate("dlrm.step"):
                loss, idx_t, g_pooled, mlps, g_mlps = self._sparse_fwd_bwd(
                    params, dense, idx, labels)
                with annotate("dlrm.dense_update"):
                    adagrad.update(mlps, g_mlps, _dense_part(acc))
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


def _dense_part(tree):
    """The dense layers of a parameter-shaped tree: the MLPs, then the
    cross layers where the model has them."""
    return {k: tree[k] for k in ("bot", "top", "cross") if k in tree}


def _rebuild(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
