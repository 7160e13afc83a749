"""The ``torch.distributed`` backend: one process per rank, NCCL on the card
and gloo on the CPU (the port's ``param_tpu/backend/tpu_backend.py``).

Each entry of ``collective_fn`` maps a name of ``SUPPORTED_COLLECTIVES`` to
its ``torch.distributed`` call and returns this rank's result with the
reference's semantics, rank for rank (rank r of a group is the reference's
device r of its mesh):

- rooted ``reduce`` leaves the reduction at the root and zeros elsewhere;
  ``broadcast``, ``gather`` (zeros off the root) and ``scatter``;
- ``all_gather_v`` gathers rank r's first ``in_split[r]`` elements into the
  ragged concatenation every rank receives; ``reduce_scatter_v`` gives rank
  r ``max(splits)`` reduced elements from offset ``sum(splits[:r])``
  (clamped to the end, like ``lax.dynamic_slice``); ``all_to_allv`` takes a
  shared split list or an (n, n) matrix and pads each receive to the
  largest one with zeros;
- ``incast`` / ``multicast`` are point-to-point sends into or out of one
  root (zeros where nothing arrives), ``pt2pt`` a set of (src, dst) pairs
  (``ppermute``: a rank that receives nothing gets zeros; a pair of a rank
  with itself is a copy).  The pt2pt calls (``send_recv``, ``ping``,
  ``window_send``) receive into buffers allocated once per shape, dtype and
  pairs, as PARAM posts into preallocated buffers: a result stays valid
  until the next call with the same shape, dtype and pairs;
- ``avg`` is the sum divided by the group size, ``prod`` the product.

The reducing collectives and ``broadcast`` work on a copy of the input, or
with ``CollectiveArgs.in_place`` in the input itself: the benchmark times
them so, without a copy of the message in each call.

NCCL collectives are library calls: in the reference they are XLA
collectives, not Pallas kernels.  A process group that cannot be set up
raises; nothing falls back to another backend or device.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from param_tpu_torch.backend.base import (
    SUPPORTED_COLLECTIVES,
    Backend,
    CollectiveArgs,
    CommGroup,
    register_backend,
)
from param_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def _offsets(splits: Sequence[int]) -> np.ndarray:
    offs = np.zeros(len(splits), dtype=np.int64)
    np.cumsum(splits[:-1], out=offs[1:])
    return offs


class DistBackend(Backend):
    """One rank of a ``torch.distributed`` world.  Under ``torchrun`` the
    world comes from its environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); started without it,
    the process is a world of one.  A default process group set up by the
    caller beforehand is used as it is."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.requested = device
        self.device: Optional[torch.device] = None
        self.rank = 0
        self.world = 1
        self.local_rank = 0
        self._default_group: Optional[CommGroup] = None
        self._groups: List[CommGroup] = []
        self._owns_pg = False
        self._recv_bufs = {}  # pt2pt receive buffers of the last shape
        self._init_collective_fns()

    # ------------------------------------------------------------------ init
    def initialize(self) -> None:
        if self.device is not None:
            return
        on_card = torch.device(self.requested).type == "cuda"
        if on_card:
            resolve_device("cuda")  # raises without a card
        backend = "nccl" if on_card else "gloo"
        env = os.environ
        self.local_rank = int(env.get("LOCAL_RANK", 0))
        if dist.is_initialized():
            got = dist.get_backend()
            if got != backend:
                raise RuntimeError(f"the default process group is {got!r}; "
                                   f"device {self.requested!r} needs "
                                   f"{backend!r}")
            self.device = (torch.device("cuda", torch.cuda.current_device())
                           if on_card else torch.device("cpu"))
        else:
            if on_card:
                self.device = torch.device("cuda", self.local_rank)
                torch.cuda.set_device(self.device)
            else:
                self.device = torch.device("cpu")
            kw = {"device_id": self.device} if on_card else {}
            if "RANK" in env and "WORLD_SIZE" in env:
                dist.init_process_group(backend, init_method="env://",
                                        rank=int(env["RANK"]),
                                        world_size=int(env["WORLD_SIZE"]),
                                        **kw)
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1, **kw)
            self._owns_pg = True
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self._default_group = CommGroup(ranks=list(range(self.world)),
                                        pg=dist.group.WORLD, pg_id=0,
                                        name="world")
        self._groups = [self._default_group]
        # the communicator works end to end, or this raises
        probe = torch.ones(1, device=self.device)
        dist.all_reduce(probe)
        if int(probe.item()) != self.world:
            raise RuntimeError(f"{backend} process group: a probe all_reduce "
                               f"gave {probe.item()}, not {self.world}")
        log.info("DistBackend: rank %d of %d on %s (%s)", self.rank,
                 self.world, self.device, backend)

    def shutdown(self) -> None:
        """Destroy the process group if this backend set it up."""
        if self._owns_pg and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_pg = False
        self.device = None

    def new_group(self, ranks: Sequence[int], pg_id: int = 0) -> CommGroup:
        """A communicator over ``ranks`` (every process must call this, in
        the same order)."""
        ranks = list(ranks)
        pg = dist.new_group(ranks)
        g = CommGroup(ranks=ranks, pg=pg if self.rank in ranks else None,
                      pg_id=pg_id, name=f"pg{pg_id}")
        self._groups.append(g)
        return g

    def make_round_robin_groups(self, num_groups: int) -> List[CommGroup]:
        """``--multi-comms``: rank r joins group r % num_groups."""
        return [self.new_group(list(range(g, self.world, num_groups))
                               or [g % self.world], pg_id=g + 1)
                for g in range(num_groups)]

    # -------------------------------------------------------------- topology
    def get_local_rank(self) -> int:
        return self.local_rank

    def get_global_rank(self) -> int:
        return self.rank

    def get_world_size(self) -> int:
        return self.world

    def get_device(self):
        return self.device

    def get_default_group(self) -> CommGroup:
        return self._default_group

    def get_groups(self) -> List[CommGroup]:
        return list(self._groups)

    def complete_ops(self) -> None:
        """The collectives are issued in their blocking form: on gloo they
        are done when they return, on NCCL the current stream waits for
        them, so finishing that stream's work finishes them."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ collectives
    def _init_collective_fns(self):
        self.collective_fn = {
            "all_reduce": self.all_reduce,
            "reduce": self.reduce,
            "all_gather": self.all_gather,
            "all_gather_base": self.all_gather,
            "all_gather_v": self.all_gather_v,
            "reduce_scatter": self.reduce_scatter,
            "reduce_scatter_base": self.reduce_scatter,
            "reduce_scatter_v": self.reduce_scatter_v,
            "all_to_all": self.all_to_all,
            "all_to_all_single": self.all_to_all,
            "all_to_allv": self.all_to_allv,
            "broadcast": self.broadcast,
            "gather": self.gather,
            "scatter": self.scatter,
            "incast": self.incast,
            "multicast": self.multicast,
            "all_gather_object": self.all_gather_object,
            "broadcast_object_list": self.broadcast_object_list,
            "pt2pt": self.send_recv,
            "barrier": lambda args: self.barrier(args.group),
        }
        missing = set(SUPPORTED_COLLECTIVES) - set(self.collective_fn)
        if missing:
            raise NotImplementedError(f"unimplemented collectives: {missing}")

    def _setup(self, args: CollectiveArgs):
        """(group, its process group, this rank's group rank, input)."""
        if args.bitwidth != 32:
            raise NotImplementedError(
                "quantized collectives (bitwidth != 32) come with "
                "comms/quantization.py, ROADMAP item 10")
        g = args.group or self._default_group
        if g.pg is None:
            raise ValueError(f"rank {self.rank} is not in group {g.ranks}")
        return g, g.pg, g.rank_of(self.rank), args.in_tensor

    @staticmethod
    def _buffer(args: CollectiveArgs, x: torch.Tensor) -> torch.Tensor:
        """The buffer a reducing collective or broadcast works in."""
        return x if args.in_place else x.clone()

    def _reduce_in_place(self, t: torch.Tensor, red_op: str, g: CommGroup):
        if red_op == "avg":
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g.pg)
            t.div_(g.size)
        elif red_op in _OPS:
            dist.all_reduce(t, op=_OPS[red_op], group=g.pg)
        else:
            raise ValueError(f"unsupported reduction {red_op!r}")
        return t

    def all_reduce(self, args: CollectiveArgs):
        g, _, _, x = self._setup(args)
        return self._reduce_in_place(self._buffer(args, x), args.red_op, g)

    def reduce(self, args: CollectiveArgs):
        """Rooted reduce: the root (``dst_rank``) gets the reduction, the
        other ranks zeros."""
        g, pg, me, x = self._setup(args)
        root = args.dst_rank
        op = "sum" if args.red_op == "avg" else args.red_op
        if op not in _OPS:
            raise ValueError(f"unsupported reduction {args.red_op!r}")
        out = self._buffer(args, x)
        dist.reduce(out, dst=g.ranks[root], op=_OPS[op], group=pg)
        if me != root:
            return out.zero_()
        return out.div_(g.size) if args.red_op == "avg" else out

    def all_gather(self, args: CollectiveArgs):
        g, pg, _, x = self._setup(args)
        out = torch.empty((g.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=pg)
        return out

    def all_gather_v(self, args: CollectiveArgs):
        """Rank r contributes its first ``in_split[r]`` elements; every rank
        receives the ragged concatenation."""
        g, pg, _, x = self._setup(args)
        n, local = g.size, x.shape[0]
        splits = list(args.in_split or [local] * n)
        if len(splits) != n or max(splits) > local:
            raise ValueError(f"in_split {splits} does not fit {n} ranks of "
                             f"{local} elements")
        padded = torch.empty((n * local, *x.shape[1:]), dtype=x.dtype,
                             device=x.device)
        dist.all_gather_into_tensor(padded, x.contiguous(), group=pg)
        return torch.cat([padded[r * local:r * local + s]
                          for r, s in enumerate(splits)])

    def reduce_scatter(self, args: CollectiveArgs):
        g, pg, me, x = self._setup(args)
        shard = x.shape[0] // g.size
        if args.red_op == "sum":
            out = torch.empty((shard, *x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, x.contiguous(), group=pg)
            return out
        y = self._reduce_in_place(self._buffer(args, x), args.red_op, g)
        return y[me * shard:(me + 1) * shard]

    def reduce_scatter_v(self, args: CollectiveArgs):
        """Rank r receives ``max(splits)`` reduced elements from offset
        ``sum(splits[:r])``, the start clamped so the slice fits."""
        g, _, me, x = self._setup(args)
        n, local = g.size, x.shape[0]
        splits = list(args.out_split or args.in_split or [local // n] * n)
        mx = max(splits)
        y = self._reduce_in_place(self._buffer(args, x), args.red_op, g)
        start = int(min(max(_offsets(splits)[me], 0), local - mx))
        return y[start:start + mx]

    def all_to_all(self, args: CollectiveArgs):
        _, pg, _, x = self._setup(args)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=pg)
        return out

    def _split_matrix(self, g: CommGroup, args: CollectiveArgs) -> np.ndarray:
        S = np.asarray(args.in_split, dtype=np.int64)
        if S.ndim == 1:
            S = np.tile(S, (g.size, 1))
        if S.shape != (g.size, g.size):
            raise ValueError(f"split matrix must be ({g.size}, {g.size}), got "
                             f"{S.shape}")
        return S

    def all_to_allv(self, args: CollectiveArgs):
        """Ragged all-to-all: ``in_split`` is a split list shared by every
        rank or an (n, n) matrix S (S[i, j] elements from rank i to rank
        j); rank r's receive is padded with zeros to the largest one."""
        g, pg, me, x = self._setup(args)
        if args.in_split is None:
            return self.all_to_all(args)
        S = self._split_matrix(g, args)
        send = [int(v) for v in S[me]]
        recv = [int(v) for v in S[:, me]]
        recv_max = int(S.sum(axis=0).max())
        got = torch.empty((sum(recv), *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_to_all_single(got, x[:sum(send)].contiguous(), recv, send,
                               group=pg)
        out = torch.zeros((recv_max, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:got.shape[0]] = got
        return out

    def broadcast(self, args: CollectiveArgs):
        g, pg, _, x = self._setup(args)
        out = self._buffer(args, x)
        dist.broadcast(out, src=g.ranks[args.src_rank], group=pg)
        return out

    def gather(self, args: CollectiveArgs):
        """Rooted gather: the root (``dst_rank``) gets every rank's shard in
        rank order, the other ranks zeros of the same shape."""
        g, pg, me, x = self._setup(args)
        root = args.dst_rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(g.size)] \
            if me == root else None
        dist.gather(x, parts, dst=g.ranks[root], group=pg)
        if me == root:
            return torch.cat(parts)
        return torch.zeros((g.size * x.shape[0], *x.shape[1:]),
                           dtype=x.dtype, device=x.device)

    def scatter(self, args: CollectiveArgs):
        """Rooted scatter: rank r gets chunk r of the root's (``src_rank``)
        buffer."""
        g, pg, me, x = self._setup(args)
        root = args.src_rank
        chunk = x.shape[0] // g.size
        out = torch.empty((chunk, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        parts = [c.contiguous() for c in x.split(chunk)[:g.size]] \
            if me == root else None
        dist.scatter(out, parts, src=g.ranks[root], group=pg)
        return out

    def _p2p(self, g: CommGroup, sends, recvs) -> None:
        """Post (tensor, group rank) sends and receives as one batch."""
        ops = [dist.P2POp(dist.isend, t, g.ranks[peer], g.pg)
               for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, g.ranks[peer], g.pg)
                for t, peer in recvs]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def incast(self, args: CollectiveArgs):
        """Many-to-one: ``dst_rank`` receives one whole buffer from each rank
        of ``src_ranks`` (default: all others) at offset src x size."""
        g, _, me, x = self._setup(args)
        dst = args.dst_rank
        srcs = list(args.src_ranks or [r for r in range(g.size) if r != dst])
        b = x.shape[0]
        out = torch.zeros((g.size * b, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        x = x.contiguous()
        if me == dst:
            recvs = []
            for s in srcs:
                if s == dst:
                    out[s * b:(s + 1) * b] = x
                else:
                    recvs.append((out[s * b:(s + 1) * b], s))
            self._p2p(g, [], recvs)
        elif me in srcs:
            self._p2p(g, [(x, dst)], [])
        return out

    def multicast(self, args: CollectiveArgs):
        """One-to-many: ``src_rank`` sends its whole buffer to each rank of
        ``dst_ranks`` (default: all others); the others get zeros."""
        g, _, me, x = self._setup(args)
        src = args.src_rank
        dsts = [d for d in (args.dst_ranks
                            or [r for r in range(g.size) if r != src])
                if d != src]
        x = x.contiguous()
        if me == src:
            self._p2p(g, [(x, d) for d in dsts], [])
            return x.clone()
        out = torch.zeros_like(x)
        if me in dsts:
            self._p2p(g, [], [(out, src)])
        return out

    # ------------------------------------------------- object collectives
    def all_gather_object(self, args: CollectiveArgs):
        """Rank r contributes ``misc["objects"][r]`` (default: its input
        tensor); every rank receives the n-object list."""
        g, pg, me, _ = self._setup(args)
        objs = args.misc.get("objects")
        mine = objs[me] if objs is not None else args.in_tensor
        gathered = [None] * g.size
        dist.all_gather_object(gathered, mine, group=pg)
        args.out_tensor = gathered
        return gathered

    def broadcast_object_list(self, args: CollectiveArgs):
        """The root's ``misc["object_list"]`` (default: its input tensor)
        replicated to every rank; returns this rank's received list."""
        g, pg, me, _ = self._setup(args)
        root = args.src_rank
        obj_list = args.misc.get("object_list")
        if obj_list is None:
            obj_list = [args.in_tensor]
        received = list(obj_list) if me == root else [None] * len(obj_list)
        dist.broadcast_object_list(received, src=g.ranks[root], group=pg)
        args.out_tensor = received
        return received

    # ------------------------------------------------------------------ p2p
    def _recv_buffer(self, x: torch.Tensor, pairs, receives: bool):
        """A receive buffer for a message like ``x`` over ``pairs`` that is
        not ``x`` itself: two per (shape, dtype, pairs), made on first use.
        Only one that nothing will arrive in is zeroed, once.  Buffers of
        another shape or dtype are dropped first, so a size sweep holds one
        size's buffers at a time."""
        shape = (tuple(x.shape), x.dtype, x.device)
        if any(k[0] != shape for k in self._recv_bufs):
            self._recv_bufs.clear()
        for slot in (0, 1):
            key = (shape, tuple(pairs), slot)
            buf = self._recv_bufs.get(key)
            if buf is None:
                make = torch.empty_like if receives else torch.zeros_like
                buf = self._recv_bufs[key] = make(x, memory_format=
                                                  torch.contiguous_format)
            if buf.data_ptr() != x.data_ptr():
                return buf
        raise AssertionError("two receive buffers cannot both alias x")

    def _permute(self, g: CommGroup, me: int, x: torch.Tensor, pairs):
        """``ppermute``: for each (src, dst) pair dst receives src's tensor;
        a rank that receives nothing gets zeros.  The result lies in a
        reused receive buffer (:meth:`_recv_buffer`)."""
        x = x.contiguous()
        receives = any(d == me for _, d in pairs)
        out = self._recv_buffer(x, pairs, receives)
        sends, recvs = [], []
        for s, d in pairs:
            if s == d == me:
                out.copy_(x)
            elif s == me:
                sends.append((x, d))
            elif d == me:
                recvs.append((out, s))
        self._p2p(g, sends, recvs)
        return out

    def send_recv(self, args: CollectiveArgs):
        """Point-to-point transfers, one per (src_ranks[i], dst_ranks[i])."""
        g, _, me, x = self._setup(args)
        return self._permute(g, me, x, list(zip(args.src_ranks,
                                                args.dst_ranks)))

    def ping(self, args: CollectiveArgs, pong: bool = False):
        """src -> dst (ping) or src -> dst -> src (ping-pong)."""
        g, _, me, x = self._setup(args)
        pairs = list(zip(args.src_ranks, args.dst_ranks))
        y = self._permute(g, me, x, pairs)
        if pong:
            y = self._permute(g, me, y, [(d, s) for s, d in pairs])
        return y

    def window_send(self, args: CollectiveArgs, window: int,
                    bidirectional: bool):
        """``window`` back-to-back transfers over the pairs (and back, when
        bidirectional), each carrying the last one's result; the steps
        alternate between the pairs' two receive buffers."""
        g, _, me, x = self._setup(args)
        pairs = list(zip(args.src_ranks, args.dst_ranks))
        if bidirectional:
            pairs += [(d, s) for s, d in pairs]
        for _ in range(window):
            x = self._permute(g, me, x, pairs)
        return x

    # ---------------------------------------------------------------- control
    def barrier(self, group: Optional[CommGroup] = None) -> None:
        g = group or self._default_group
        dist.barrier(group=g.pg)


register_backend("dist", DistBackend)
