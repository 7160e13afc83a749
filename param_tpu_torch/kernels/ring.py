"""K8a-d: ring collectives (``csrc/ring.cu``) and their plain PyTorch
versions.

A collective takes ``shards``, one tensor per rank, as the reference's
single controller hands one local array per device to its kernel inside
``shard_map``, and returns one result per rank:

- K8a all-gather: (local...) -> (n, local...), with rank src's shard at
  index ``(src + shift) % n`` (``shift`` 1 is the reference's roll by one
  after the all-reduce's gather);
- K8b reduce-scatter: (n c, ...) -> (c, ...), rank r ending with the full
  sum of chunk ``(r + 1) % n``, added in the input dtype in the ring's order;
- K8c both-direction all-gather: as K8a, half the hops each way;
- K8d loopback: a copy of each shard to itself behind the neighbour barrier.

All shards on one card run as one launch (the ranks are ``blockIdx.y``);
shards on n distinct cards run as one launch per card through peer
pointers (peer access is enabled first).  The plain versions walk the same
ring schedule on the list of shards: the same hops, the same additions in
the same order, so the kernels match them bit for bit.  Counterparts of
``param_tpu/ops/ring_collectives.py``'s ``_ring_all_gather_kernel``,
``_ring_reduce_scatter_kernel``, ``_bidir_all_gather_kernel`` and
``_loopback_kernel``.

K8a, K8b and K8c walk slices: :func:`ring_plan` (a pure function of the
kind, the chunk's bytes, the rank count, the co-resident capacity and
whether all ranks share a card) picks the route, the blocks a rank, the
slice bytes S, the ``lag`` in steps between a slice's hops, K8b's slots a
hop and the signals' scope, so that a forwarded slice is read back from L2
(K8a, K8c), and K8b's partial sums pass through shared memory (one card, 2
to 8 ranks: the cluster route) or through a global workspace of blocks x
(n - 1) x slots x S bytes a rank whatever the chunk.  S, the lag and the
slots are this module's constants; :func:`forced_route` makes K8b take
one route (tests, and holding the route the plan did not pick).  K8c's
hops are :func:`bidir_lanes`.  K8d, and K8a-c over one rank (a copy),
copy the chunk in tiles through the card's bulk-copy engine, the tiles
dealt out to the blocks as they go.

Every wait in the kernels is bounded (``timeout_s``); a wait that runs out
sets an error word, and the wrapper raises (by default it synchronises and
reads the word after each call; ``check=False`` leaves that to
:func:`check_errors`, as a CUDA-graph capture needs).  After an error the
workspace's flags are zeroed, so the next call starts clean.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts

MAX_RANKS = 16
MAX_BLOCKS = 1024  # per rank: csrc/ring.cu's kMaxBlocks (ring_max_blocks)
BLOCK_BYTES = 10 * 1024  # the copy: chunk bytes a block before another
# (one tile of the bulk copy, csrc/ring.cu's kCopyTile)
LOOPBACK_BLOCK_BYTES = 4 * BLOCK_BYTES  # K8d: a block's share fits its 4
# slots, since each block also pays the handshake
SLICE_BYTES = 8 * 1024  # K8a-c: bytes of one slice of one hop (twice that
# where a step has at most two jobs)
ACROSS_SLICE_BYTES = 64 * 1024  # K8a-c with one rank a card
LAG = 1  # steps between a slice's hop and its next hop
SLOTS = LAG + 1  # K8b's slots a hop (more than the lag, or the ring would
# wait on itself)
L2_BUDGET = 32 << 20  # bytes of one card's slices in flight, times lag + 1
ACROSS_BUDGET = 128 << 20  # the same across cards, where the link binds:
# it only bounds K8b's workspace
CLUSTER_SMEM = 64 * 1024  # cluster K8b: slot bytes a block (three an SM)
CLUSTER_MAX_RANKS = 8  # the portable cluster size
CLUSTER_MIN_INPUT = 4 << 20  # K8b takes the cluster route from this many
# input bytes a rank: below it the cluster's set-up costs more than it
# saves (both routes' times on the H100, chip_smoke.py phase 17, cross
# between 2 and 4 MiB at n 2 and 8; at n = 4 they tie at 2 MiB)
TIMEOUT_S = 1.0
ADD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_KINDS = {"all_gather": 0, "reduce_scatter": 1, "bidir": 2, "loopback": 3}
_ROUTE_KINDS = {"cluster": 4, "copy": 5}  # csrc/ring.cu's kernels for them
_SLICED = ("all_gather", "reduce_scatter", "bidir")  # over two or more ranks
_SCOPES = {"gpu": 0, "sys": 1}
_COUNTS = {"all_gather": "ring_all_gather",
           "reduce_scatter": "ring_reduce_scatter",
           "bidir": "ring_bidir_all_gather", "loopback": "ring_loopback"}
_WAITS = {1: "ready flag", 2: "freed ack", 3: "neighbour barrier"}
ROUTES = ("memory", "cluster")  # K8b's routes over two or more ranks
_forced_route: Optional[str] = None  # the route forced_route sets, if any


# ------------------------------------------------------------ plain versions
def _from_left(send: List[torch.Tensor], like: Sequence[torch.Tensor], step):
    """What each rank receives in one hop: rank r gets ``send[r - step]``."""
    n = len(send)
    return [send[(r - step) % n].to(like[r].device) for r in range(n)]


def ring_all_gather_plain(shards: Sequence[torch.Tensor],
                          shift: int = 0) -> List[torch.Tensor]:
    """K8a's ring on the list of shards: n - 1 hops to the right."""
    n = len(shards)
    outs = [torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
            for x in shards]
    for r, x in enumerate(shards):
        outs[r][(r + shift) % n] = x
    send = list(shards)
    for i in range(n - 1):
        send = _from_left(send, shards, 1)
        for r in range(n):  # after hop i rank r holds rank r - i - 1's shard
            outs[r][((r - i - 1) % n + shift) % n] = send[r]
    return outs


def _chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"the leading dimension of a {tuple(x.shape)} shard "
                         f"must divide by the {n} ranks")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def ring_reduce_scatter_plain(
        shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K8b's ring: rank r starts by sending its chunk r; at each hop it adds
    its own share of the chunk that arrived (received + own, in the input
    dtype) and passes the sum on; it ends with the sum of chunk r + 1."""
    n = len(shards)
    xs = [_chunks(x, n) for x in shards]
    send = [xs[r][r] for r in range(n)]
    for i in range(n - 1):
        recv = _from_left(send, shards, 1)
        send = [recv[r] + xs[r][(r - i - 1) % n] for r in range(n)]
    return [s.clone() for s in send] if n == 1 else send


def ring_all_gather_bidir_plain(
        shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K8c's rings: ceil((n-1)/2) hops clockwise (shards of the ranks to
    the left) and floor((n-1)/2) counter-clockwise (to the right)."""
    n = len(shards)
    outs = [torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
            for x in shards]
    for r, x in enumerate(shards):
        outs[r][r] = x
    cw, ccw = list(shards), list(shards)
    for i in range(max(n // 2, (n - 1) // 2)):
        if i < n // 2:
            cw = _from_left(cw, shards, 1)
            for r in range(n):
                outs[r][(r - i - 1) % n] = cw[r]
        if i < (n - 1) // 2:
            ccw = _from_left(ccw, shards, -1)
            for r in range(n):
                outs[r][(r + i + 1) % n] = ccw[r]
    return outs


def bidir_lanes(n: int) -> List[Tuple[int, int]]:
    """K8c's hops over ``n`` ranks as warp 0's lanes plan them: lane j is
    (direction, hop), direction 0 clockwise (to the right, carrying rank r
    - hop's chunk), 1 counter-clockwise (to the left, rank r + hop's).
    There are n // 2 clockwise hops and (n - 1) // 2 counter-clockwise
    ones, as in the reference; the counter-clockwise hop 0 reads the same
    input as the clockwise one, so lane 0 runs both (``csrc/ring.cu``'s
    ``bidir_lanes`` and ``bidir_hop``)."""
    cw, ccw = n // 2, (n - 1) // 2
    return [(0, i) for i in range(cw)] + [(1, k) for k in range(1, ccw)]


def ring_loopback_plain(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K8d: each shard copied to itself."""
    return [x.clone() for x in shards]


# ------------------------------------------------------------------ plan
@dataclass(frozen=True)
class RingPlan:
    """How one ring launch cuts its chunk (``chunk_bytes`` a rank).

    ``blocks`` a rank, each over ``per_block`` bytes (a 16-byte multiple;
    the last block takes the rest); each block's range in slices of
    ``slice_bytes`` (the last one ragged); a slice's hop i runs ``lag``
    steps after its hop i - 1; K8b receives each hop in ``slots`` slots of
    one slice, in global memory (``route`` "memory": ``workspace_bytes``
    of them a rank) or, on K8b's ``route`` "cluster" (one card, 2 to 8
    ranks, block b of every rank one thread-block cluster), in the
    receiver's shared memory; over one rank they are a copy (``route``
    "copy", one slice a block); ``scope`` "gpu" when all ranks share a
    card, else "sys"."""
    kind: str
    blocks: int
    per_block: int
    slice_bytes: int
    lag: int
    slots: int
    scope: str
    workspace_bytes: int
    route: str = "memory"

    @property
    def sliced(self) -> bool:
        return self.kind in _SLICED and self.route != "copy"

    def text(self) -> str:
        if not self.sliced:
            return (f"{self.blocks} blocks a rank, one range of "
                    f"{self.per_block} B each, {self.scope} scope")
        slots = (f", {self.slots} slots a hop in "
                 f"{'shared' if self.route == 'cluster' else 'global'} "
                 f"memory" if self.slots else "")
        return (f"{self.blocks} blocks a rank, S {self.slice_bytes} B, lag "
                f"{self.lag}{slots}, {self.scope} scope")


def cluster_shape(n: int) -> Tuple[int, int, int]:
    """The cluster K8b's (slice bytes, slots a hop, shared-memory bytes a
    block) for ``n`` ranks: ``SLOTS`` slices for each of the n - 1 hops
    that receive, the largest power-of-two slice up to ``SLICE_BYTES``
    (twice that for two ranks) whose slots fit in ``CLUSTER_SMEM``."""
    slice_bytes = SLICE_BYTES * (2 if n <= 2 else 1)
    while slice_bytes > 16 and (n - 1) * SLOTS * slice_bytes > CLUSTER_SMEM:
        slice_bytes //= 2
    return slice_bytes, SLOTS, (n - 1) * SLOTS * slice_bytes


def _per_block(chunk_bytes: int, blocks: int, slice_bytes: int) -> int:
    """Bytes a block: whole slices where a block has more than one, else a
    16-byte multiple."""
    per_block = -(-chunk_bytes // blocks)
    per_block = (-(-per_block // slice_bytes) * slice_bytes
                 if per_block > slice_bytes else -(-per_block // 16) * 16)
    return max(16, per_block)


def ring_plan(kind: str, chunk_bytes: int, n: int, capacity: int,
              one_card: bool, max_blocks: int = MAX_BLOCKS,
              cluster_capacity: int = 0,
              route: Optional[str] = None, sms: int = 0) -> RingPlan:
    """The launch plan of ring kernel ``kind`` for ``chunk_bytes`` a rank
    over ``n`` ranks, when ``capacity`` blocks of it fit on a card at once
    (``cluster_capacity`` clusters of K8b's cluster kernel), the kernel
    takes at most ``max_blocks`` blocks a rank, and ``one_card`` says
    whether every rank is on the same card.

    K8a-c on one card: slices of ``SLICE_BYTES`` (twice that where a step
    has at most two jobs, so a step still moves enough bytes; K8c's hop 0
    is one job for both directions), blocks a
    rank within the capacity, ``max_blocks`` and the L2 budget (ranks on
    the card x hops x slice x (LAG + 1), or x SLOTS for K8b if more, bytes
    in flight at most ``L2_BUDGET``; K8c's n - 1 hops a step count as
    K8a's), and no more than there are slices.
    Across cards, slices of ``ACROSS_SLICE_BYTES`` within ``ACROSS_BUDGET``:
    the link, not the L2, binds there, and a system-scope signal costs
    more, so a step moves more.  K8b with 2 to 8 ranks on one card and at
    least ``CLUSTER_MIN_INPUT`` input bytes a rank takes the cluster
    route (slots in shared memory, :func:`cluster_shape`) where a cluster
    fits, with up to ``cluster_capacity`` blocks a rank; ``route`` (what
    :func:`forced_route` sets) makes K8b over two or more ranks take that
    route whatever the size, and raises where it cannot run.

    K8d, and K8a-c over one rank (a copy, ``route`` "copy"): a block for
    each ``BLOCK_BYTES`` (K8d: ``LOOPBACK_BLOCK_BYTES``) up to the capacity
    and ``max_blocks``, so a large chunk fills the card with a whole number
    of blocks an SM; K8d takes at most ``sms`` blocks a rank (one an SM,
    where ``sms`` is given), since each block pays the handshake.  The
    bulk copy deals the tiles out to the blocks as they go; the word copy
    (bases or a count not 16-byte multiples, or the plain copy of a chunk
    of one tile or less) takes one range a block."""
    if kind not in _KINDS:
        raise ValueError(f"unknown ring kernel {kind!r}")
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"the rings take 1 to {MAX_RANKS} ranks, got {n}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown K8b route {route!r}; one of {ROUTES}")
    ranks_here = n if one_card else 1
    if capacity < ranks_here:
        raise RuntimeError(f"{ranks_here} ranks of the ring kernel cannot all "
                           f"be resident on one card ({capacity} blocks fit)")
    scope = "gpu" if one_card else "sys"
    cap_blocks = min(max_blocks, capacity // ranks_here)
    sliced = kind in _SLICED
    if not sliced or n == 1:  # K8d, and the copy over one rank
        if kind == "loopback" and sms:
            cap_blocks = min(cap_blocks, sms)
        share = LOOPBACK_BLOCK_BYTES if kind == "loopback" else BLOCK_BYTES
        blocks = max(1, min(math.ceil(chunk_bytes / share), cap_blocks))
        per_block = max(16, -(-chunk_bytes // blocks // 16) * 16)
        blocks = max(1, -(-chunk_bytes // per_block))
        if not sliced:
            return RingPlan(kind, blocks, per_block, per_block, 0, 0, scope, 0)
        # K8a-c over one rank: the rank's own copy
        return RingPlan(kind, blocks, per_block,
                        1 << (per_block - 1).bit_length(), 0, 0, scope, 0,
                        "copy")
    adds = kind == "reduce_scatter"
    hops = n if adds else n - 1
    can_cluster = (adds and one_card and 2 <= n <= CLUSTER_MAX_RANKS and
                   cluster_capacity > 0)
    if adds and route == "cluster" and not can_cluster:
        raise ValueError(f"the cluster route takes K8b over 2 to "
                         f"{CLUSTER_MAX_RANKS} ranks on one card where a "
                         f"cluster fits; got n={n}, one_card={one_card}, "
                         f"{cluster_capacity} clusters")
    if can_cluster and (n * chunk_bytes >= CLUSTER_MIN_INPUT
                        if route is None else route == "cluster"):
        size, nslots, _ = cluster_shape(n)
        blocks = max(1, min(max_blocks, cluster_capacity,
                            math.ceil(chunk_bytes / size)))
        per_block = _per_block(chunk_bytes, blocks, size)
        return RingPlan(kind, max(1, -(-chunk_bytes // per_block)), per_block,
                        size, LAG, nslots, scope, 0, "cluster")
    # jobs a step: K8c's hop 0 is one job for both directions
    jobs = len(bidir_lanes(n)) if kind == "bidir" else hops
    slice_bytes = (SLICE_BYTES * (2 if jobs <= 2 else 1) if one_card
                   else ACROSS_SLICE_BYTES)
    nslots = SLOTS if adds else 0
    in_flight = ranks_here * hops * slice_bytes * max(LAG + 1, nslots)
    budget = L2_BUDGET if one_card else ACROSS_BUDGET
    blocks = max(1, min(cap_blocks, budget // in_flight,
                        math.ceil(chunk_bytes / slice_bytes)))
    per_block = _per_block(chunk_bytes, blocks, slice_bytes)
    blocks = max(1, -(-chunk_bytes // per_block))
    work = blocks * (n - 1) * nslots * slice_bytes if adds else 0
    return RingPlan(kind, blocks, per_block, slice_bytes, LAG, nslots, scope,
                    work)


@contextlib.contextmanager
def forced_route(route: str):
    """Within the block every K8b launch over two or more ranks takes
    ``route`` ("memory" or "cluster") instead of the one :func:`ring_plan`
    picks, and raises where ``route`` cannot run (the cluster route across
    cards, or over more than ``CLUSTER_MAX_RANKS`` ranks).  The other ring
    kernels have one route each and are not affected."""
    global _forced_route
    if route not in ROUTES:
        raise ValueError(f"unknown K8b route {route!r}; one of {ROUTES}")
    outer, _forced_route = _forced_route, route
    try:
        yield
    finally:
        _forced_route = outer


# ------------------------------------------------------------------ CUDA
@lru_cache(maxsize=None)
def _capacity(kind: int, dtype: int, scope: int, device: int) -> int:
    cap = bindings.entry("ring", "ring_capacity")(kind, dtype, scope, device)
    if cap < 0:
        raise RuntimeError(f"ring_capacity failed with CUDA error {-cap}")
    return cap


@lru_cache(maxsize=None)
def _cluster_capacity(dtype: int, n: int, smem: int, device: int) -> int:
    cap = bindings.entry("ring", "ring_cluster_capacity")(dtype, n, smem,
                                                           device)
    if cap < 0:
        raise RuntimeError(f"ring_cluster_capacity failed with CUDA error "
                           f"{-cap}")
    return cap


@lru_cache(maxsize=None)
def _enable_peer_access(device: int, peer: int) -> None:
    if not torch.cuda.can_device_access_peer(device, peer):
        raise RuntimeError(f"cuda:{device} cannot reach cuda:{peer} by peer "
                           f"access; the rings across cards need it")
    bindings.check(bindings.entry("ring", "ring_enable_peer")(device, peer),
                   f"peer access cuda:{device} -> cuda:{peer}")


class _Workspace:
    """Per-rank flag words and the reduce-scatter's slots (``ring_plan``'s
    workspace bytes, the largest asked for so far) of one set of ranks,
    the error word, and (across cards) one event per card that every
    rank's start waits on.  The gathers need no slots: they write straight
    into the neighbour's output."""

    def __init__(self, devices: Tuple[torch.device, ...]):
        words = bindings.entry("ring", "ring_flag_words")()
        self.devices = devices
        self.flags = [torch.zeros(words, dtype=torch.int64, device=d)
                      for d in devices]
        self.err = torch.zeros(1, dtype=torch.int32, device=devices[0])
        self.slots = [torch.empty(256, dtype=torch.uint8, device=d)
                      for d in devices]
        self.slot_bytes = 256
        self.queued = [torch.cuda.Event() for _ in devices]
        self.streams: List[torch.cuda.Stream] = []

    def ensure_slots(self, nbytes: int) -> None:
        if nbytes <= self.slot_bytes:
            return
        self.sync()  # no launch may still use the old slots
        size = -(-nbytes // 256) * 256
        self.slots = [torch.empty(size, dtype=torch.uint8, device=d)
                      for d in self.devices]
        self.slot_bytes = size

    def sync(self) -> None:
        for d in set(self.devices):
            torch.cuda.synchronize(d)

    def raise_if_failed(self) -> None:
        self.sync()
        code = int(self.err.item()) & 0xFFFFFFFF
        if code == 0:
            return
        for f in self.flags:  # the ranks stopped mid-protocol: start clean
            f.zero_()
        self.err.zero_()
        self.sync()
        kind = next(k for k, v in _KINDS.items() if v == (code >> 24) & 0x7F)
        raise RuntimeError(
            f"ring {kind}: a bounded wait ran out (rank {(code >> 16) & 0xFF}, "
            f"hop {(code >> 4) & 0xFFF}, waiting for the "
            f"{_WAITS.get(code & 0xF, '?')}); the kernel stopped instead of "
            f"hanging")


_workspaces: Dict[Tuple[torch.device, ...], _Workspace] = {}


def _workspace(shards: Sequence[torch.Tensor]) -> _Workspace:
    devices = tuple(x.device for x in shards)
    ws = _workspaces.get(devices)
    if ws is None:
        if len(set(devices)) > 1:
            for d in devices:
                for p in devices:
                    if d != p:
                        _enable_peer_access(d.index, p.index)
        ws = _workspaces[devices] = _Workspace(devices)
    return ws


def check_errors(shards: Sequence[torch.Tensor]) -> None:
    """Synchronise the shards' cards and raise if a ring kernel launched on
    them since the last check ran out of a bounded wait."""
    ws = _workspaces.get(tuple(x.device for x in shards))
    if ws is not None:
        ws.raise_if_failed()


def _check_shards(shards: Sequence[torch.Tensor], adds: bool) -> None:
    n = len(shards)
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"the rings take 1 to {MAX_RANKS} ranks, got {n}")
    x0 = shards[0]
    for x in shards:
        if x.device.type != "cuda":
            raise ValueError("the ring kernels take CUDA shards")
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError("every shard must have the same shape and dtype")
        if not x.is_contiguous():
            raise ValueError("the ring kernels take contiguous shards")
    devices = [x.device for x in shards]
    if len(set(devices)) not in (1, n):
        raise ValueError("shards must all lie on one card or each on its own")
    if adds and x0.dtype not in ADD_DTYPES:
        raise TypeError(f"the reduce-scatter ring adds f32, bf16 or f16, got "
                        f"{x0.dtype}")


def launch_plan(kind: str, shards: Sequence[torch.Tensor],
                chunk: int) -> RingPlan:
    """:func:`ring_plan` for ``shards`` (CUDA) and ``chunk`` bytes a rank,
    with the capacity of the kernel on their cards and the route
    :func:`forced_route` sets, if any."""
    n = len(shards)
    one_card = len({x.device for x in shards}) == 1
    # the capacity of the kernel that runs: over one rank, the copy
    code = _ROUTE_KINDS["copy"] if n == 1 and kind in _SLICED else \
        _KINDS[kind]
    dtype = ADD_DTYPES.get(shards[0].dtype, 0)
    scope = _SCOPES["gpu" if one_card else "sys"]
    cap = min(_capacity(code, dtype, scope, d.index)
              for d in {x.device for x in shards})
    clusters = 0
    if (kind == "reduce_scatter" and one_card and
            2 <= n <= CLUSTER_MAX_RANKS):
        clusters = _cluster_capacity(dtype, n, cluster_shape(n)[2],
                                     shards[0].device.index)
    return ring_plan(kind, chunk, n, cap, one_card,
                     bindings.entry("ring", "ring_max_blocks")(), clusters,
                     _forced_route if kind == "reduce_scatter" else None,
                     min(bindings.sm_count(d.index)
                         for d in {x.device for x in shards}))


def _count(kind: str, plan: RingPlan) -> None:
    """One launch of ``kind``; K8a-c also count it by route."""
    launch_counts[_COUNTS[kind]] += 1
    if kind in _SLICED:
        launch_counts[f"{_COUNTS[kind]}_{plan.route}"] += 1


def _launch(kind: str, shards: Sequence[torch.Tensor],
            outs: Sequence[torch.Tensor], chunk: int, shift: int, fault: int,
            timeout_s: float, check: bool) -> None:
    n = len(shards)
    ws = _workspace(shards)
    one_card = len(set(ws.devices)) == 1
    dtype = ADD_DTYPES.get(shards[0].dtype, 0)
    plan = launch_plan(kind, shards, chunk)
    code = _ROUTE_KINDS.get(plan.route, _KINDS[kind])
    scope = _SCOPES[plan.scope]
    ws.ensure_slots(plan.workspace_bytes)
    if chunk == 0:
        return
    vec = int(chunk % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for ts in (shards, outs) for t in ts))
    table = [(ctypes.c_longlong * n)(*[t.data_ptr() for t in ts])
             for ts in (shards, outs, ws.slots, ws.flags)]
    fn = bindings.entry("ring", "ring_launch")
    args = (chunk, plan.per_block, plan.blocks,
            plan.slice_bytes.bit_length() - 1 if plan.sliced else 0,
            plan.lag, plan.slots, vec, shift, fault, int(timeout_s * 1e9),
            ws.err.data_ptr())
    if one_card:
        d = ws.devices[0]
        rc = fn(code, dtype, scope, n, 0, n, d.index, *table, *args,
                torch.cuda.current_stream(d).cuda_stream)
        bindings.check(rc, f"ring {kind}")
        _count(kind, plan)
    else:
        streams = [torch.cuda.current_stream(d) for d in ws.devices]
        if streams != ws.streams:  # the last call may run on other streams
            ws.sync()
            ws.streams = streams
        # every rank starts once the work queued before it on every card is
        # done, the last ring call with it, so no card's bounded wait runs
        # while a peer still works through its own queue
        for ev, s in zip(ws.queued, streams):
            ev.record(s)
        for r, s in enumerate(streams):
            for p, ev in enumerate(ws.queued):
                if p != r:
                    s.wait_event(ev)
        for r, (d, s) in enumerate(zip(ws.devices, streams)):
            rc = fn(code, dtype, scope, n, r, 1, d.index, *table, *args,
                    s.cuda_stream)
            bindings.check(rc, f"ring {kind} on {d}")
            _count(kind, plan)
    if check:
        ws.raise_if_failed()


def ring_all_gather_cuda(shards: Sequence[torch.Tensor], shift: int = 0, *,
                         fault: int = 0, timeout_s: float = TIMEOUT_S,
                         check: bool = True) -> List[torch.Tensor]:
    """Launch K8a; returns one (n, local...) tensor per rank."""
    shards = list(shards)
    _check_shards(shards, adds=False)
    n = len(shards)
    outs = [torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
            for x in shards]
    nbytes = shards[0].numel() * shards[0].element_size()
    _launch("all_gather", shards, outs, nbytes, shift % n, fault, timeout_s,
            check)
    return outs


def ring_reduce_scatter_cuda(shards: Sequence[torch.Tensor], *,
                             fault: int = 0, timeout_s: float = TIMEOUT_S,
                             check: bool = True) -> List[torch.Tensor]:
    """Launch K8b; returns one (c, ...) tensor per rank (the shards are
    (n c, ...)), on the route :func:`ring_plan` picks (or
    :func:`forced_route` sets)."""
    shards = list(shards)
    _check_shards(shards, adds=True)
    n = len(shards)
    like = _chunks(shards[0], n)[0]
    outs = [torch.empty(like.shape, dtype=x.dtype, device=x.device)
            for x in shards]
    nbytes = like.numel() * like.element_size()
    _launch("reduce_scatter", shards, outs, nbytes, 0, fault, timeout_s,
            check)
    return outs


def ring_all_gather_bidir_cuda(shards: Sequence[torch.Tensor], *,
                               fault: int = 0, timeout_s: float = TIMEOUT_S,
                               check: bool = True) -> List[torch.Tensor]:
    """Launch K8c; returns one (n, local...) tensor per rank."""
    shards = list(shards)
    _check_shards(shards, adds=False)
    n = len(shards)
    outs = [torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
            for x in shards]
    nbytes = shards[0].numel() * shards[0].element_size()
    _launch("bidir", shards, outs, nbytes, 0, fault, timeout_s, check)
    return outs


def ring_loopback_cuda(shards: Sequence[torch.Tensor], *,
                       timeout_s: float = TIMEOUT_S,
                       check: bool = True) -> List[torch.Tensor]:
    """Launch K8d; returns a copy of each shard."""
    shards = list(shards)
    _check_shards(shards, adds=False)
    outs = [torch.empty_like(x) for x in shards]
    nbytes = shards[0].numel() * shards[0].element_size()
    _launch("loopback", shards, outs, nbytes, 0, 0, timeout_s, check)
    return outs
