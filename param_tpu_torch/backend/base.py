"""Backend abstraction: the distributed-communication layer (the port's
``param_tpu/backend/base.py``).

The harness never calls ``torch.distributed`` directly: every collective
goes through ``backend.collective_fn[name]``, as in the reference (and in
PARAM's ``backendFunctions``, ``train/comms/pt/pytorch_backend_utils.py``).

The reference is single-controller: a group is a mesh of devices and a
tensor is a global array sharded over it.  The port runs one process per
rank (``torchrun``): a :class:`CommGroup` is a ``torch.distributed``
process group over a list of global ranks, and every tensor in a
:class:`CollectiveArgs` is this rank's local tensor.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Type

log = logging.getLogger(__name__)

# Collectives every backend provides (PARAM's ``supportedCollectives``).
SUPPORTED_COLLECTIVES = [
    "reduce",
    "all_reduce",
    "all_to_all",
    "all_to_allv",
    "all_to_all_single",
    "all_gather",
    "all_gather_v",
    "all_gather_base",
    "broadcast",
    "reduce_scatter",
    "reduce_scatter_v",
    "reduce_scatter_base",
    "gather",
    "scatter",
    "incast",
    "multicast",
    "all_gather_object",
    "broadcast_object_list",
    "barrier",
    "pt2pt",
]

# host-mediated collectives: every call pickles Python objects on the host,
# so they are timed per call
OBJECT_COLLECTIVES = {"all_gather_object", "broadcast_object_list"}

REDUCE_OPS = ["sum", "max", "min", "prod", "avg"]


@dataclass
class CommGroup:
    """A communicator: an ordered list of global ranks and the
    ``torch.distributed`` process group over them (``None`` in a process
    that is not a member).  Group rank i is global rank ``ranks[i]``."""

    ranks: List[int]
    pg: Any = None
    pg_id: int = 0
    name: str = ""

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rank_of(self, global_rank: int) -> int:
        return self.ranks.index(global_rank)


@dataclass
class CollectiveArgs:
    """Per-op argument holder passed to every collective function
    (PARAM's ``collectiveArgsHolder``).  Tensors are this rank's own."""

    group: Optional[CommGroup] = None
    in_tensor: Any = None
    out_tensor: Any = None
    # reduction op for reduce-style collectives
    red_op: str = "sum"
    # root rank (in the group) for rooted collectives
    src_rank: int = 0
    dst_rank: int = 0
    # ragged splits for *_v collectives: per-rank element counts (all_to_allv
    # also takes an (n, n) matrix: S[i][j] elements from rank i to rank j)
    in_split: Optional[Sequence[Any]] = None
    out_split: Optional[Sequence[int]] = None
    # pt2pt
    src_ranks: List[int] = field(default_factory=list)
    dst_ranks: List[int] = field(default_factory=list)
    window: int = 100
    # quantized-communication bitwidth (32 = off; the only value the port
    # takes until the quantization tier is ported)
    bitwidth: int = 32
    # the reducing collectives and broadcast work in ``in_tensor`` itself,
    # as PARAM and nccl-tests time them; False: on a copy of it, leaving
    # the input as it was
    in_place: bool = False
    # opaque slot benchmarks use to stash per-op state
    misc: Dict[str, Any] = field(default_factory=dict)


class Backend:
    """Abstract backend (PARAM's ``backendFunctions``).

    Subclasses fill ``self.collective_fn`` with an entry for every name in
    ``SUPPORTED_COLLECTIVES``; each takes a :class:`CollectiveArgs` and
    returns this rank's result, possibly still in flight on the device
    until :meth:`complete_ops`.
    """

    def __init__(self):
        self.collective_fn: Dict[str, Callable[[CollectiveArgs], Any]] = {}

    # -- init / topology ---------------------------------------------------
    def initialize(self) -> None:
        raise NotImplementedError

    def get_local_rank(self) -> int:
        raise NotImplementedError

    def get_global_rank(self) -> int:
        raise NotImplementedError

    def get_world_size(self) -> int:
        raise NotImplementedError

    def get_device(self):
        raise NotImplementedError

    def get_default_group(self) -> CommGroup:
        raise NotImplementedError

    def get_groups(self) -> List[CommGroup]:
        raise NotImplementedError

    def new_group(self, ranks: Sequence[int], pg_id: int = 0) -> CommGroup:
        raise NotImplementedError

    # -- completion --------------------------------------------------------
    def complete_ops(self) -> None:
        """Wait until every issued op has finished on the device (PARAM's
        ``complete_accel_ops``)."""
        raise NotImplementedError

    def barrier(self, group: Optional[CommGroup] = None) -> None:
        raise NotImplementedError

    # -- reporting ---------------------------------------------------------
    def get_bus_bw(self, collective: str, alg_bw_gbs: float,
                   group=None) -> float:
        from param_tpu_torch.utils.bw import bus_bw_factor

        n = (group or self.get_default_group()).size
        return alg_bw_gbs * bus_bw_factor(collective, n)

    def benchmark_comms(self, bench_time_fn, *args):
        """Run the benchmark body under this backend."""
        return bench_time_fn(*args)


# -- registry ---------------------------------------------------------------
_BACKENDS: Dict[str, Type[Backend]] = {}


def register_backend(name: str, cls: Type[Backend]) -> None:
    _BACKENDS[name] = cls


def get_backend_cls(name: str) -> Type[Backend]:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; known: "
                         f"{sorted(_BACKENDS)}") from None
