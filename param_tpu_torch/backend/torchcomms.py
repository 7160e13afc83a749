"""A torchcomms-style communicator API over the ``torch.distributed``
backend (the port's ``param_tpu/backend/torchcomms.py``; PARAM's
``pytorch_torchcomms_backend.py``).

A communicator object (:class:`TorchComm`, made by :func:`new_comm` or
``split``) takes tensors and returns work handles:

- ``async_op=True``: all_reduce, reduce, all_gather, reduce_scatter,
  all_to_all and broadcast are posted with ``torch.distributed``'s own
  ``async_op=True``; the :class:`Work` wraps that ``dist.Work`` and
  ``wait()`` waits on it (on NCCL the current stream waits for the
  collective's stream).  The other calls run to their end and return a
  finished :class:`Work`.
- all_reduce, reduce and broadcast work in the tensor given, as torch's
  own calls do; ``result()`` is the output (waiting first), with the
  reference's values: zeros off the root of a reduce, ``avg`` the mean.
- ``split(ranks)`` makes a sub-communicator (``Backend.new_group``).

``register_backend("torchcomms", TorchcommsBackend)`` puts the facade
under every harness CLI: ``--backend torchcomms`` routes the collectives
of the standard sweeps through it.  Quantized all_reduce / reduce
(``--bitwidth`` 16 or 8) defer to the plain backend: the communicator's
calls take no bitwidth.
"""

from __future__ import annotations

import datetime
import enum
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from param_tpu_torch.backend.base import (
    Backend,
    CollectiveArgs,
    CommGroup,
    get_backend_cls,
    register_backend,
)
from param_tpu_torch.backend.dist_backend import _OPS, DistBackend


class ReduceOp(enum.Enum):
    """Reduction enums (PARAM's ``reduce_op_map``)."""

    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PRODUCT = "prod"
    AVG = "avg"


def _red(op) -> str:
    if isinstance(op, ReduceOp):
        return op.value
    if isinstance(op, str) and op.upper() in ReduceOp.__members__:
        return ReduceOp[op.upper()].value
    if isinstance(op, str):
        return op
    raise ValueError(f"unknown reduce op {op!r}")


class Work:
    """A work handle: ``wait()`` waits for the posted collective (if it is
    still in flight) and finishes the result; ``result()`` waits, then
    returns the output."""

    def __init__(self, result: Any, work=None,
                 finish: Optional[Callable[[Any], Any]] = None):
        self._result = result
        self._work = work
        self._finish = finish

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._work is not None:
            if timeout is None:
                self._work.wait()
            else:
                self._work.wait(datetime.timedelta(seconds=timeout))
            self._work = None
        if self._finish is not None:
            self._result = self._finish(self._result)
            self._finish = None
        return True

    def result(self) -> Any:
        self.wait()
        return self._result


class TorchComm:
    """A communicator over one group of a :class:`DistBackend`."""

    def __init__(self, backend: Optional[Backend] = None,
                 group: Optional[CommGroup] = None):
        if backend is None:
            backend = DistBackend()
            backend.initialize()
        self._b = backend
        self._g = group or backend.get_default_group()

    # -- introspection ---------------------------------------------------
    @property
    def group(self) -> CommGroup:
        return self._g

    def size(self) -> int:
        return self._g.size

    def rank(self) -> int:
        return self._b.get_global_rank()

    def split(self, ranks: Sequence[int], pg_id: int = 1) -> "TorchComm":
        """A sub-communicator over ``ranks`` (every rank calls it)."""
        return TorchComm(self._b, self._b.new_group(ranks, pg_id=pg_id))

    # -- posted collectives ---------------------------------------------
    @staticmethod
    def _done(w: Work, async_op: bool):
        return w if async_op else (w.wait() and w)

    def _pg(self):
        if self._g.pg is None:
            raise ValueError(f"rank {self.rank()} is not in group "
                             f"{self._g.ranks}")
        return self._g.pg

    def all_reduce(self, tensor, op=ReduceOp.SUM, async_op: bool = False):
        red = _red(op)
        if red not in _OPS and red != "avg":
            raise ValueError(f"unsupported reduction {red!r}")
        w = dist.all_reduce(tensor, op=_OPS["sum" if red == "avg" else red],
                            group=self._pg(), async_op=True)
        n = self._g.size
        return self._done(Work(tensor, w, (lambda t: t.div_(n))
                               if red == "avg" else None), async_op)

    def reduce(self, tensor, root: int = 0, op=ReduceOp.SUM,
               async_op: bool = False):
        red = _red(op)
        if red not in _OPS and red != "avg":
            raise ValueError(f"unsupported reduction {red!r}")
        me = self._g.rank_of(self.rank())
        w = dist.reduce(tensor, dst=self._g.ranks[root],
                        op=_OPS["sum" if red == "avg" else red],
                        group=self._pg(), async_op=True)
        n = self._g.size

        def finish(t):
            if me != root:
                return t.zero_()
            return t.div_(n) if red == "avg" else t

        return self._done(Work(tensor, w, finish), async_op)

    def all_gather(self, tensor, async_op: bool = False):
        x = tensor.contiguous()
        out = torch.empty((self._g.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        w = dist.all_gather_into_tensor(out, x, group=self._pg(),
                                        async_op=True)
        return self._done(Work(out, w), async_op)

    def all_to_all(self, tensor, async_op: bool = False):
        out = torch.empty_like(tensor, memory_format=torch.contiguous_format)
        w = dist.all_to_all_single(out, tensor.contiguous(),
                                   group=self._pg(), async_op=True)
        return self._done(Work(out, w), async_op)

    def broadcast(self, tensor, root: int = 0, async_op: bool = False):
        w = dist.broadcast(tensor, src=self._g.ranks[root], group=self._pg(),
                           async_op=True)
        return self._done(Work(tensor, w), async_op)

    def reduce_scatter(self, tensor, op=ReduceOp.SUM,
                       async_op: bool = False):
        red = _red(op)
        if red != "sum":
            # the other reductions: the plain backend's all-reduce + slice
            return self._run("reduce_scatter", async_op, in_tensor=tensor,
                             red_op=red)
        x = tensor.contiguous()
        out = torch.empty((x.shape[0] // self._g.size, *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        w = dist.reduce_scatter_tensor(out, x, group=self._pg(),
                                       async_op=True)
        return self._done(Work(out, w), async_op)

    # -- collectives the plain backend runs to their end ------------------
    def _run(self, name: str, async_op: bool, **kw) -> Work:
        args = CollectiveArgs(group=self._g, **kw)
        # the class's method, not the dispatch table: TorchcommsBackend
        # routes its table through this facade
        return self._done(Work(getattr(DistBackend, name)(self._b, args)),
                          async_op)

    def all_gather_v(self, tensor, in_split: Sequence[int],
                     async_op: bool = False):
        return self._run("all_gather_v", async_op, in_tensor=tensor,
                         in_split=in_split)

    def all_to_all_v(self, tensor, in_split: Sequence[int],
                     out_split: Optional[Sequence[int]] = None,
                     async_op: bool = False):
        return self._run("all_to_allv", async_op, in_tensor=tensor,
                         in_split=in_split, out_split=out_split)

    def reduce_scatter_v(self, tensor, op=ReduceOp.SUM,
                         out_split: Optional[Sequence[int]] = None,
                         async_op: bool = False):
        """Ragged reduce_scatter: rank r receives ``max(out_split)``
        reduced elements from offset ``sum(out_split[:r])``."""
        return self._run("reduce_scatter_v", async_op, in_tensor=tensor,
                         red_op=_red(op), out_split=out_split)

    def gather(self, tensor, root: int = 0, async_op: bool = False):
        return self._run("gather", async_op, in_tensor=tensor, dst_rank=root)

    def scatter(self, tensor, root: int = 0, async_op: bool = False):
        return self._run("scatter", async_op, in_tensor=tensor,
                         src_rank=root)

    def send_recv(self, tensor, src_ranks: Sequence[int],
                  dst_ranks: Sequence[int], async_op: bool = False):
        """Paired point-to-point transfers, one per (src, dst) pair; a rank
        that receives nothing gets zeros."""
        return self._run("send_recv", async_op, in_tensor=tensor,
                         src_ranks=list(src_ranks),
                         dst_ranks=list(dst_ranks))

    def incast(self, tensor, root: int = 0,
               src_ranks: Optional[Sequence[int]] = None,
               async_op: bool = False):
        return self._run("incast", async_op, in_tensor=tensor, dst_rank=root,
                         src_ranks=list(src_ranks or []))

    def multicast(self, tensor, root: int = 0,
                  dst_ranks: Optional[Sequence[int]] = None,
                  async_op: bool = False):
        return self._run("multicast", async_op, in_tensor=tensor,
                         src_rank=root, dst_ranks=list(dst_ranks or []))

    def barrier(self) -> None:
        self._b.barrier(self._g)

    # -- object collectives ------------------------------------------------
    def all_gather_object(self, obj: Any) -> List[Any]:
        """This rank's ``obj`` from every rank, in rank order."""
        return DistBackend.all_gather_object(
            self._b, CollectiveArgs(group=self._g, in_tensor=obj))

    def broadcast_object_list(self, objs: List[Any], root: int = 0):
        return DistBackend.broadcast_object_list(
            self._b, CollectiveArgs(group=self._g, src_rank=root,
                                    misc={"object_list": list(objs)}))


def new_comm(backend: str = "dist", group: Optional[CommGroup] = None,
             **backend_kw) -> TorchComm:
    """A communicator over a new backend of the registered name
    (torchcomms' ``new_comm``)."""
    b = get_backend_cls(backend)(**backend_kw)
    b.initialize()
    return TorchComm(b, group)


def _buf(a: CollectiveArgs):
    """The tensor an in-place facade call works in."""
    return a.in_tensor if a.in_place else a.in_tensor.clone()


class TorchcommsBackend(DistBackend):
    """The harness backend whose collectives go through :class:`TorchComm`
    (every tensor collective, pt2pt and the object collectives), so
    ``--backend torchcomms`` drives the communicator API under the
    standard sweeps."""

    # dispatch-table name -> facade call (comm, args) -> Work
    _FACADE_OPS = {
        "all_reduce": lambda c, a: c.all_reduce(
            _buf(a), op=a.red_op, async_op=True),
        "reduce": lambda c, a: c.reduce(
            _buf(a), root=a.dst_rank, op=a.red_op, async_op=True),
        "all_gather": lambda c, a: c.all_gather(a.in_tensor, async_op=True),
        "all_gather_base": lambda c, a: c.all_gather(
            a.in_tensor, async_op=True),
        "all_gather_v": lambda c, a: c.all_gather_v(
            a.in_tensor, a.in_split, async_op=True),
        "reduce_scatter": lambda c, a: c.reduce_scatter(
            a.in_tensor, op=a.red_op, async_op=True),
        "reduce_scatter_base": lambda c, a: c.reduce_scatter(
            a.in_tensor, op=a.red_op, async_op=True),
        "reduce_scatter_v": lambda c, a: c.reduce_scatter_v(
            a.in_tensor, op=a.red_op, out_split=a.out_split or a.in_split,
            async_op=True),
        "all_to_all": lambda c, a: c.all_to_all(a.in_tensor, async_op=True),
        "all_to_all_single": lambda c, a: c.all_to_all(
            a.in_tensor, async_op=True),
        "all_to_allv": lambda c, a: c.all_to_all_v(
            a.in_tensor, a.in_split, a.out_split, async_op=True)
        if a.in_split is not None else c.all_to_all(a.in_tensor,
                                                    async_op=True),
        "broadcast": lambda c, a: c.broadcast(
            _buf(a), root=a.src_rank, async_op=True),
        "gather": lambda c, a: c.gather(
            a.in_tensor, root=a.dst_rank, async_op=True),
        "scatter": lambda c, a: c.scatter(
            a.in_tensor, root=a.src_rank, async_op=True),
        "incast": lambda c, a: c.incast(
            a.in_tensor, root=a.dst_rank, src_ranks=a.src_ranks,
            async_op=True),
        "multicast": lambda c, a: c.multicast(
            a.in_tensor, root=a.src_rank, dst_ranks=a.dst_ranks,
            async_op=True),
        "pt2pt": lambda c, a: c.send_recv(
            a.in_tensor, a.src_ranks, a.dst_ranks, async_op=True),
    }

    def _init_collective_fns(self):
        # the table is set once, at construction, so a trace recording
        # started before or after initialize() wraps the facade's entries
        super()._init_collective_fns()
        for name in self._FACADE_OPS:
            self.collective_fn[name] = self._via_facade(name)
        self.collective_fn["all_gather_object"] = self._all_gather_object
        self.collective_fn["broadcast_object_list"] = \
            self._broadcast_object_list

    def initialize(self) -> None:
        super().initialize()
        self.comm = TorchComm(self, self.get_default_group())

    def _comm_for(self, args: CollectiveArgs) -> TorchComm:
        return (self.comm if args.group in (None, self.comm.group)
                else TorchComm(self, args.group))

    def _via_facade(self, name: str):
        call = self._FACADE_OPS[name]

        def run(args: CollectiveArgs):
            if (name in ("all_reduce", "reduce") and args.bitwidth != 32
                    and args.red_op == "sum"):
                # no bitwidth in the communicator's calls: the plain path
                return getattr(DistBackend, name)(self, args)
            return call(self._comm_for(args), args).result()

        return run

    def _all_gather_object(self, args: CollectiveArgs):
        comm = self._comm_for(args)
        objs = args.misc.get("objects")
        mine = (objs[comm.group.rank_of(self.rank)] if objs is not None
                else args.in_tensor)
        gathered = comm.all_gather_object(mine)
        args.out_tensor = gathered
        return gathered

    def _broadcast_object_list(self, args: CollectiveArgs):
        lst = args.misc.get("object_list")
        received = self._comm_for(args).broadcast_object_list(
            list(lst) if lst is not None else [args.in_tensor],
            root=args.src_rank)
        args.out_tensor = received
        return received


register_backend("torchcomms", TorchcommsBackend)
