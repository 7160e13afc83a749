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

Every wait in the kernels is bounded (``timeout_s``); a wait that runs out
sets an error word, and the wrapper raises (by default it synchronises and
reads the word after each call; ``check=False`` leaves that to
:func:`check_errors`, as a CUDA-graph capture needs).  After an error the
workspace's flags are zeroed, so the next call starts clean.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts

MAX_RANKS = 16
BLOCK_BYTES = 64 * 1024  # chunk bytes per block before another is added
TIMEOUT_S = 1.0
ADD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_KINDS = {"all_gather": 0, "reduce_scatter": 1, "bidir": 2, "loopback": 3}
_COUNTS = {"all_gather": "ring_all_gather",
           "reduce_scatter": "ring_reduce_scatter",
           "bidir": "ring_bidir_all_gather", "loopback": "ring_loopback"}
_WAITS = {1: "ready flag", 2: "freed ack", 3: "neighbour barrier"}


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


def ring_loopback_plain(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K8d: each shard copied to itself."""
    return [x.clone() for x in shards]


# ------------------------------------------------------------------ CUDA
@lru_cache(maxsize=None)
def _capacity(kind: int, dtype: int, device: int) -> int:
    cap = bindings.entry("ring", "ring_capacity")(kind, dtype, device)
    if cap < 0:
        raise RuntimeError(f"ring_capacity failed with CUDA error {-cap}")
    return cap


@lru_cache(maxsize=None)
def _enable_peer_access(device: int, peer: int) -> None:
    if not torch.cuda.can_device_access_peer(device, peer):
        raise RuntimeError(f"cuda:{device} cannot reach cuda:{peer} by peer "
                           f"access; the rings across cards need it")
    bindings.check(bindings.entry("ring", "ring_enable_peer")(device, peer),
                   f"peer access cuda:{device} -> cuda:{peer}")


class _Workspace:
    """Per-rank flag words and the reduce-scatter's two comm slots of one
    set of ranks, the error word, and (across cards) one event per card
    that every rank's start waits on.  The gathers need no slots: they
    write straight into the neighbour's output."""

    def __init__(self, devices: Tuple[torch.device, ...]):
        words = bindings.entry("ring", "ring_flag_words")()
        self.devices = devices
        self.flags = [torch.zeros(words, dtype=torch.int64, device=d)
                      for d in devices]
        self.err = torch.zeros(1, dtype=torch.int32, device=devices[0])
        self.slots: List[torch.Tensor] = []
        self.slot_bytes = 0
        self.queued = [torch.cuda.Event() for _ in devices]
        self.streams: List[torch.cuda.Stream] = []

    def ensure_slots(self, nbytes: int) -> None:
        if nbytes <= self.slot_bytes:
            return
        self.sync()  # no launch may still use the old slots
        size = -(-nbytes // 256) * 256
        self.slots = [torch.empty(2 * size, dtype=torch.uint8, device=d)
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


def _launch(kind: str, shards: Sequence[torch.Tensor],
            outs: Sequence[torch.Tensor], chunk: int, shift: int, fault: int,
            timeout_s: float, check: bool) -> None:
    n = len(shards)
    ws = _workspace(shards)
    if kind == "reduce_scatter":
        ws.ensure_slots(chunk)
    if chunk == 0:
        return
    one_card = len(set(ws.devices)) == 1
    ranks_here = n if one_card else 1
    code = _KINDS[kind]
    dtype = ADD_DTYPES.get(shards[0].dtype, 0)
    cap = min(_capacity(code, dtype, d.index) for d in set(ws.devices))
    if cap < ranks_here:
        raise RuntimeError(f"{ranks_here} ranks of the ring kernel cannot all "
                           f"be resident on one card ({cap} blocks fit)")
    max_blocks = bindings.entry("ring", "ring_max_blocks")()
    blocks = max(1, min(math.ceil(chunk / BLOCK_BYTES), max_blocks,
                        cap // ranks_here))
    per_block = -(-chunk // blocks // 16) * 16
    blocks = -(-chunk // per_block)
    table = [(ctypes.c_longlong * n)(*[t.data_ptr() for t in ts])
             for ts in (shards, outs, ws.slots, ws.flags)]
    fn = bindings.entry("ring", "ring_launch")
    args = (chunk, per_block, blocks, ws.slot_bytes, shift, fault,
            int(timeout_s * 1e9), ws.err.data_ptr())
    if one_card:
        d = ws.devices[0]
        rc = fn(code, dtype, n, 0, n, d.index, *table, *args,
                torch.cuda.current_stream(d).cuda_stream)
        bindings.check(rc, f"ring {kind}")
        launch_counts[_COUNTS[kind]] += 1
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
            rc = fn(code, dtype, n, r, 1, d.index, *table, *args,
                    s.cuda_stream)
            bindings.check(rc, f"ring {kind} on {d}")
            launch_counts[_COUNTS[kind]] += 1
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
    (n c, ...))."""
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
