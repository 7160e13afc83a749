"""Carry parameters over from the reference package's layout.

The reference's DLRM parameter tree ``{"tables": (T, E, D), "bot": [(W, b),
...], "top": [...]}`` (as numpy arrays) has the same layout as the port's, so
conversion is a copy to torch tensors on ``device``; so are that of an MLP's
list of (W, b) pairs, a transformer block's dict and the MoE layer's.  A
rank of a sharded model takes its slice of the full tree: a sharded DLRM's
(:func:`params_shard_from_jax`, :func:`adagrad_state_shard_from_jax`), a tp
rank's block (:func:`tp_shard_from_jax`) or MLP
(:func:`mlp_tp_shard_from_jax`), a pipeline stage's block of the stacked
tree (:func:`stage_params_from_jax`) and an expert's slab
(:func:`moe_expert_from_jax`).  The operator microbench's flax modules
(convnets, ``nn.Linear`` / ``nn.Conv2d``) carry over by their flax names
(:func:`flax_params_from_jax`: a dense (in, out) kernel becomes ``weight.T``,
an HWIO conv kernel OIHW), CvT layer parameters by key
(:func:`cvt_params_from_jax`; a depthwise (kh, kw, 1, C) kernel becomes (C,
1, kh, kw)) and ``BatchedEmbedding``'s tables as they are
(:func:`batched_embedding_from_jax`).  Used by the tests and
``chip_smoke.py`` so that both packages start from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from param_tpu_torch.models.moe import expert_shard
from param_tpu_torch.models.transformer import tp_shard
from param_tpu_torch.ops.mlp import mlp_tp_shard
from param_tpu_torch.utils.device import resolve_device


def _tensor(a, dev, requires_grad: bool = False) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # JAX's bf16 reaches numpy as ml_dtypes.bfloat16, which
        # torch.from_numpy refuses: carry the bits over unchanged
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev).requires_grad_(requires_grad)


def _convert(tree, dev, requires_grad: bool):
    return {
        "tables": _tensor(tree["tables"], dev, requires_grad),
        "bot": [(_tensor(w, dev, requires_grad), _tensor(b, dev, requires_grad))
                for w, b in tree["bot"]],
        "top": [(_tensor(w, dev, requires_grad), _tensor(b, dev, requires_grad))
                for w, b in tree["top"]],
    }


def params_from_jax(np_params, device="cuda"):
    """The reference's parameter tree (numpy leaves) as the port's params:
    fresh tensors on ``device`` that require grad."""
    return _convert(np_params, resolve_device(device), True)


def _table_shard(np_tree, rank: int, world: int):
    """``np_tree`` with only rank ``rank``'s tables of ``world``: tables
    [rank*T/world, (rank+1)*T/world), the rest whole."""
    tables = np.asarray(np_tree["tables"])
    if tables.shape[0] % world:
        raise ValueError(f"{tables.shape[0]} tables do not split over "
                         f"{world} ranks")
    t = tables.shape[0] // world
    return {**np_tree, "tables": tables[rank * t:(rank + 1) * t]}


def params_shard_from_jax(np_params, rank: int, world: int, device="cuda"):
    """Rank ``rank``'s parameters of a DLRM sharded over ``world`` ranks,
    from the reference's full tree (numpy leaves): its table shard and the
    whole MLPs, as :func:`params_from_jax` makes them."""
    return params_from_jax(_table_shard(np_params, rank, world), device)


def adagrad_state_shard_from_jax(np_acc, rank: int, world: int,
                                 device="cuda"):
    """Rank ``rank``'s part of a full params-shaped accumulator tree (numpy
    leaves), as :func:`adagrad_state_from_jax` makes it."""
    return adagrad_state_from_jax(_table_shard(np_acc, rank, world), device)


def mlp_params_from_jax(np_params, device="cuda"):
    """The reference's MLP params, a list of (W (din, dout), b (dout,))
    numpy pairs (e.g. from its ``init_mlp``), as the port's: fresh tensors
    on ``device`` in the same dtypes, not requiring grad."""
    dev = resolve_device(device)
    return [(_tensor(w, dev, False), _tensor(b, dev, False))
            for w, b in np_params]


def adagrad_state_from_jax(np_acc, device="cuda"):
    """A params-shaped accumulator tree (numpy leaves; e.g. the reference's
    ``init_adagrad_state`` or optax's ``sum_of_squares``), a DLRM's tree or
    an MLP's list of (W, b) pairs, as the port's Adagrad state."""
    if isinstance(np_acc, dict):
        return _convert(np_acc, resolve_device(device), False)
    return mlp_params_from_jax(np_acc, device)


def transformer_params_from_jax(np_params, device="cuda"):
    """A transformer block's parameters from the reference (numpy leaves,
    bf16 ones as ``ml_dtypes.bfloat16``) as the port's, bit for bit: LN
    (gamma, beta) pairs, plain matrices, int8 (weights, scales) pairs and
    int4 (carriers, scales, group) triples; the group stays an int."""
    dev = resolve_device(device)

    def leaf(x):
        if np.ndim(x) == 0 and np.asarray(x).dtype.kind in "iu":
            return int(x)  # the int4 group size
        return _tensor(x, dev)

    def conv(v):
        return tuple(map(leaf, v)) if isinstance(v, (tuple, list)) else leaf(v)

    return {k: conv(v) for k, v in np_params.items()}


def tp_shard_from_jax(np_params, cfg, tp_rank: int, tp: int, device="cuda"):
    """Tensor-parallel rank ``tp_rank``'s shard of ``tp`` of a transformer
    block (:func:`~param_tpu_torch.models.transformer.tp_shard`), from the
    reference's whole block (numpy leaves); ``cfg`` is the port's
    ``TransformerConfig``."""
    return tp_shard(transformer_params_from_jax(np_params, device), cfg,
                    tp_rank, tp)


def stage_params_from_jax(np_stacked, stage: int, device="cuda"):
    """Pipeline stage ``stage``'s block of the reference's stacked tree
    (``init_stacked_params``; leaves with a leading stage axis)."""
    return transformer_params_from_jax(
        {k: (tuple(np.asarray(t)[stage] for t in v)
             if isinstance(v, (tuple, list)) else np.asarray(v)[stage])
         for k, v in np_stacked.items()}, device)


def moe_params_from_jax(np_params, device="cuda"):
    """The reference's MoE parameters (``init_moe_params``: ``wr``, ``w1``,
    ``w2``) as the port's, bit for bit."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in np_params.items()}


def moe_expert_from_jax(np_params, e: int, device="cuda"):
    """Expert ``e``'s rank of the MoE layer: the router and expert e's
    slabs (:func:`~param_tpu_torch.models.moe.expert_shard`)."""
    return expert_shard(moe_params_from_jax(np_params, device), e)


def mlp_tp_shard_from_jax(np_params, tp_rank: int, tp: int, device="cuda"):
    """Tensor-parallel rank ``tp_rank``'s MLP of ``tp``
    (:func:`~param_tpu_torch.ops.mlp.mlp_tp_shard`) from the reference's
    list of (W, b) numpy pairs."""
    return mlp_tp_shard(mlp_params_from_jax(np_params, device), tp_rank, tp)


def _kernel_to_weight(kernel) -> np.ndarray:
    """A flax kernel in the port's layout: dense (in, out) -> (out, in),
    conv HWIO -> OIHW (a depthwise (kh, kw, 1, C) -> (C, 1, kh, kw))."""
    k = np.asarray(kernel)
    return k.T if k.ndim == 2 else k.transpose(3, 2, 0, 1)


def flax_params_from_jax(np_params, module: torch.nn.Module, device="cuda"):
    """Load a flax parameter tree (numpy leaves; ``{"params": ...}`` or its
    inside) into ``module``, whose submodules carry flax's names
    (``Conv_0.weight`` <- ``Conv_0/kernel``), and move it to ``device``;
    returns the module."""
    tree = np_params.get("params", np_params)
    module = module.to(resolve_device(device))
    with torch.no_grad():
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node[part]
            v = node["bias"] if leaf == "bias" else _kernel_to_weight(
                node["kernel"])
            p.copy_(_tensor(v, p.device))
    return module


def cvt_params_from_jax(np_params, device="cuda"):
    """A CvT layer's parameters (``init_conv_projection`` /
    ``init_patch_embed``, numpy leaves) as the port's: ``w`` HWIO -> OIHW,
    the rest copied."""
    dev = resolve_device(device)
    return {k: _tensor(_kernel_to_weight(v) if k == "w" else v, dev)
            for k, v in np_params.items()}


def batched_embedding_from_jax(op, np_tables, device="cuda"):
    """Set a built ``BatchedEmbeddingOp``'s (T, R, D) tables to the JAX
    op's (numpy)."""
    op.tables = _tensor(np_tables, resolve_device(device))
    return op
