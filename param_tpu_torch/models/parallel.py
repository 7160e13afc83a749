"""Differentiable collectives for the multi-device transformer tier: the
explicit ``torch.distributed`` counterparts of the collectives that the
reference's ``shard_map`` programs place (or XLA inserts) on a mesh axis.

A group is a :class:`~param_tpu_torch.backend.base.CommGroup` (its global
ranks and its process group); group rank i is device i of the reference's
mesh axis.

- :func:`mesh_groups`: each rank's dp and tp groups of a 2-D (dp, tp) mesh,
  ranks numbered row-major as ``Mesh(devs.reshape(dp, tp), ("dp", "tp"))``.
- :func:`copy_to_group` / :func:`reduce_from_group`: Megatron's conjugate
  pair.  The first is the identity forward and an all-reduce (sum) of the
  gradient backward, and goes before a column-parallel matmul; the second
  all-reduces forward and passes the gradient through, and goes after a
  row-parallel matmul.
- :func:`gather_from_group`: all-gather on the last axis forward; backward
  this rank's slice of the gradient, not summed.  The sum belongs to the
  :func:`copy_to_group` in front of each column-parallel matmul that reads
  the gathered tensor; together the two backwards make the reduce-scatter
  that transposes the gather.
- :func:`all_to_all`: ``lax.all_to_all(x, axis, split_axis=0,
  concat_axis=0, tiled=True)``, whose transpose is itself.
- :func:`ring_hop`: ``lax.ppermute`` with ``perm=[(i, (i + 1) % n)]``: send
  to group rank me + 1, receive from me - 1, both posted together
  (``batch_isend_irecv``) so that no ring of gloo or NCCL ranks can
  deadlock; ``reverse`` runs the hop the other way, which is its transpose.
  :class:`RingHop` is the hop as an autograd function.
- :func:`all_reduce_mean`: ``lax.pmean`` of a list of tensors in one call.

Every collective runs in a group of one too (a copy), as the reference's
collectives run on a mesh axis of size one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.distributed as dist

from param_tpu_torch.backend.base import CommGroup


def group_rank(group: CommGroup) -> int:
    """This process's rank in ``group``."""
    return dist.get_rank(group.pg)


@dataclass(frozen=True)
class MeshGroups:
    """One rank's groups of a (dp, tp) mesh and its place in it."""

    dp: CommGroup
    tp: CommGroup

    @property
    def dp_index(self) -> int:
        return group_rank(self.dp)

    @property
    def tp_index(self) -> int:
        return group_rank(self.tp)


def mesh_groups(world, dp: int, tp: int) -> MeshGroups:
    """This rank's dp group (the ranks of its tp index) and tp group (the
    ranks of its dp index) of a (dp, tp) mesh over ``world`` ranks (an int,
    or a backend with ``get_world_size()``).  Every rank calls
    ``dist.new_group`` for every group, in the same order."""
    n = world if isinstance(world, int) else world.get_world_size()
    if dp * tp != n:
        raise ValueError(f"mesh ({dp}, {tp}) does not cover {n} ranks")
    me = dist.get_rank()
    mine = {}
    for axis, groups in (
            ("dp", [[j * tp + i for j in range(dp)] for i in range(tp)]),
            ("tp", [[j * tp + i for i in range(tp)] for j in range(dp)])):
        for ranks in groups:
            pg = dist.new_group(ranks)
            if me in ranks:
                mine[axis] = CommGroup(ranks=ranks, pg=pg, name=axis)
    return MeshGroups(**mine)


def _all_reduce(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group.pg)
    return y


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x.contiguous(), group=group.pg)
    return torch.cat(parts, dim=-1)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.width, ctx.rank = x.shape[-1], group_rank(group)
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        c, r = ctx.width, ctx.rank
        return g[..., r * c:(r + 1) * c].contiguous(), None


def _all_to_all(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    send = x.contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group.pg)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """Identity; the gradient is all-reduced (summed) over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the gradient passes through."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated on the last axis in group-rank order;
    the gradient is this rank's slice of it (see the module notes)."""
    return _GatherFromGroup.apply(x, group)


def all_to_all(x: torch.Tensor, group: CommGroup) -> torch.Tensor:
    """Tiled all-to-all on axis 0: block j of ``x``'s n equal row blocks
    goes to group rank j, and the result stacks the blocks received, in
    source-rank order.  Differentiable; its transpose is itself."""
    return _AllToAll.apply(x, group)


def ring_hop(tensors: Sequence[torch.Tensor], group: CommGroup,
             reverse: bool = False) -> List[torch.Tensor]:
    """Each tensor sent to group rank me + 1 and received from me - 1 (the
    other way with ``reverse``), all sends and receives posted in one
    ``batch_isend_irecv``.  In a group of one, copies."""
    n = group.size
    if n == 1:
        return [t.clone() for t in tensors]
    me = group_rank(group)
    step = -1 if reverse else 1
    dst, src = group.ranks[(me + step) % n], group.ranks[(me - step) % n]
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, group.pg) for t in sends]
           + [dist.P2POp(dist.irecv, t, src, group.pg) for t in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


class RingHop(torch.autograd.Function):
    """:func:`ring_hop` of one tensor; its backward is the reverse hop:
    ``RingHop.apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_hop([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_hop([g], ctx.group, reverse=True)[0], None


def all_reduce_mean(tensors, pg, n: int):
    """The mean over the ranks of each tensor, by one ``all_reduce`` of
    their concatenation (``lax.pmean`` of each leaf)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=pg)
    flat.div_(n)
    return [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]
