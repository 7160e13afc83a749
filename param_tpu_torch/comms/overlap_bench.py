"""Overlap benchmarks: collective x collective and collective x compute (the
port's ``param_tpu/comms/overlap_bench.py``; PARAM's ``commsOverlapBench``
and ``commsComputeBench``).

Each measurement runs chains of steps and compares the time of a step of
A alone, of B alone and of both together:

    overlap_efficiency = (sum(solo) - t_both) / (sum(solo) - max(solo))

1.0 means everything but the longest was hidden, 0.0 that they ran one
after another.  Collective x collective modes (``--overlap-pair-pgs``):

- same-group: every collective of the set runs at full size on its own
  tensor and in its own process group over the same ranks, so that NCCL
  runs each on its own stream (one group would serialise them on one
  stream); a step posts them all with ``async_op=True``, then waits;
- split-pgs: two half-world groups run the collective at once, against
  one half running it alone.

Collective x compute: the collective is posted with ``async_op=True`` and
the compute (``num_compute`` chained ``torch.matmul``, or sum-pooled
lookups through ``ops.embedding.embedding_bag``, which is K1 on the card,
or ``non_blocking`` copies between 4 pinned host buffers and the card) runs
on the current stream meanwhile.

Every chain keeps a running f32 checksum of its outputs on the device and
reads it once, all-reduced over the world, at its end (the reference's
chain value); the benches return it, so a chain can be held against the
reference's.  A step's time is the median over windows of ``n_hi`` steps
timed with CUDA events on the card, ``time.perf_counter`` on gloo.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from param_tpu_torch.backend.base import Backend, CommGroup
from param_tpu_torch.utils.bw import alg_bw, bus_bw_factor
from param_tpu_torch.utils.dtypes import dtype_from_name, dtype_size
from param_tpu_torch.utils.timer import time_ms

REPS = 5


def _coll_step(name: str, group: CommGroup, damp: float):
    """A shape-preserving chainable collective step over ``group``:
    ``post(x)`` issues the collective with ``async_op=True`` and returns a
    function that waits for it and gives the next carry."""
    pg = group.pg
    if name == "all_reduce":
        def post(x):
            y = x.clone()
            w = dist.all_reduce(y, group=pg, async_op=True)
            return lambda: (w.wait(), y * damp)[1]
    elif name == "all_to_all":
        def post(x):
            y = torch.empty_like(x)
            w = dist.all_to_all_single(y, x, group=pg, async_op=True)
            return lambda: (w.wait(), y)[1]
    elif name == "all_gather":
        def post(x):
            y = torch.empty((group.size * x.shape[0],), dtype=x.dtype,
                            device=x.device)
            w = dist.all_gather_into_tensor(y, x, group=pg, async_op=True)
            return lambda: (w.wait(), y.reshape(group.size, x.shape[0])
                            .mean(0).to(x.dtype))[1]
    elif name == "reduce_scatter":
        def post(x):
            y = torch.empty((x.shape[0] // group.size,), dtype=x.dtype,
                            device=x.device)
            w = dist.reduce_scatter_tensor(y, x, group=pg, async_op=True)
            return lambda: (w.wait(), (y * damp).repeat(group.size))[1]
    else:
        raise ValueError(f"unsupported overlap collective {name!r}")
    return post


@dataclass
class OverlapResult:
    """N-way overlap measurement: each collective's solo step time and
    the step time with all of them at full size on their own tensors."""

    solo_us: tuple
    t_both_us: float

    @property
    def t_a_us(self) -> float:
        return self.solo_us[0]

    @property
    def t_b_us(self) -> float:
        return self.solo_us[1]

    @property
    def overlap_efficiency(self) -> float:
        """(sum(solo) - t_both) / (sum(solo) - max(solo)): 1.0 = everything
        hidden behind the longest collective, 0.0 = fully serialized."""
        total = sum(self.solo_us)
        hideable = total - max(self.solo_us)
        if hideable <= 0:
            return 0.0
        saved = total - self.t_both_us
        return max(0.0, min(1.0, saved / hideable))


class Chain:
    """A chain of steps over carried buffers with an on-device checksum.

    ``colls``: (post, buffer) pairs, each post a :func:`_coll_step`;
    ``compute``: optional ``f(i) -> f32 scalar tensor`` run between
    posting the collectives and waiting for them.  A step adds every new
    carry's f32 sum and the compute's value to the checksum."""

    def __init__(self, colls, compute: Optional[Callable] = None,
                 world: Optional[CommGroup] = None, device=None):
        self.posts = [p for p, _ in colls]
        self.init = [b for _, b in colls]
        self.compute = compute
        self.world = world
        self.device = device
        self.reset()

    def reset(self) -> None:
        self.vs = [b.clone() for b in self.init]
        self.s = torch.zeros((), dtype=torch.float32, device=self.device)
        self.i = 0

    def step(self) -> None:
        pending = [post(v) for post, v in zip(self.posts, self.vs)]
        s = self.s
        if self.compute is not None:
            s = s + self.compute(self.i)
        self.vs = [finish() for finish in pending]
        for v in self.vs:
            s = s + v.float().sum()
        self.s = s
        self.i += 1

    def checksum(self) -> float:
        """The checksum summed over the world (one host read)."""
        s = self.s.clone()
        if self.world is not None:
            dist.all_reduce(s, group=self.world.pg)
        return float(s.item())

    def run(self, n: int) -> float:
        """The checksum of ``n`` steps from the start."""
        self.reset()
        for _ in range(n):
            self.step()
        return self.checksum()

    def time_us(self, n_hi: int) -> float:
        """Median microseconds a step over windows of ``n_hi`` steps."""
        self.reset()
        return time_ms(self.step, n_hi, self.device, warmup=1,
                       reps=REPS) * 1e3


def _rank_slice(host: np.ndarray, n: int, r: int) -> np.ndarray:
    """Rank r's shard of a global array split in n along dim 0."""
    per = host.shape[0] // n
    return host[r * per:(r + 1) * per]


class OverlapBench:
    """Collective x collective overlap (PARAM's ``commsOverlapBench``) on
    the ranks of ``backend``."""

    def __init__(self, backend: Backend, dtype: str = "float32"):
        self.backend = backend
        self.dtype = dtype_from_name(dtype)
        self.elem = dtype_size(self.dtype)
        self._pgs: List[CommGroup] = []
        self._halves: Optional[List[CommGroup]] = None

    def _groups(self, k: int) -> List[CommGroup]:
        """k process groups over the whole world, made once (every rank
        makes them in the same order)."""
        b = self.backend
        while len(self._pgs) < k:
            self._pgs.append(b.new_group(range(b.get_world_size()),
                                         pg_id=100 + len(self._pgs)))
        return self._pgs[:k]

    def _tensor(self, host: np.ndarray, n: int, r: int) -> torch.Tensor:
        return torch.from_numpy(_rank_slice(host, n, r).copy()).to(
            self.backend.get_device()).to(self.dtype)

    def same_group_chains(self, coll_a: str, coll_pair, size_bytes: int
                          ) -> List[Chain]:
        """[solo chain of each collective..., the chain of all of them]:
        collective i works on the global array ``default_rng(i).random``
        of ``size_bytes`` sharded over the ranks, in its own group."""
        pair = [coll_pair] if isinstance(coll_pair, str) else list(coll_pair)
        names = [coll_a] + pair
        b = self.backend
        n, r = b.get_world_size(), b.get_global_rank()
        elems = max(n, size_bytes // self.elem) // n * n
        groups = self._groups(len(names))
        steps = [_coll_step(c, g, 1.0 / n) for c, g in zip(names, groups)]
        xs = [self._tensor(np.random.default_rng(seed).random(elems)
                           .astype(np.float32), n, r)
              for seed in range(len(names))]
        world, dev = b.get_default_group(), b.get_device()
        solos = [Chain([(f, x)], world=world, device=dev)
                 for f, x in zip(steps, xs)]
        return solos + [Chain(list(zip(steps, xs)), world=world, device=dev)]

    def run_same_group(self, coll_a: str, coll_pair, size_bytes: int,
                       n_hi: int = 16) -> OverlapResult:
        """The main collective and a pair list over all ranks, every one
        at full ``size_bytes`` on its own tensor and group."""
        *solos, both = self.same_group_chains(coll_a, coll_pair, size_bytes)
        solo_us = tuple(c.time_us(n_hi) for c in solos)
        return OverlapResult(solo_us, both.time_us(n_hi))

    def split_pgs_chains(self, coll: str, size_bytes: int) -> List[Chain]:
        """[one half's chain alone, both halves' chain]; the first is None
        on the ranks of the second half.  Rank r of the world is rank
        r % (n / 2) of half r // (n / 2)."""
        b = self.backend
        n, r = b.get_world_size(), b.get_global_rank()
        if n < 4 or n % 2:
            raise ValueError("split-pgs mode needs an even device count >= 4")
        half = n // 2
        if self._halves is None:
            self._halves = [b.new_group(range(h * half, (h + 1) * half),
                                        pg_id=200 + h) for h in (0, 1)]
        mine = self._halves[r // half]
        elems = max(half, size_bytes // self.elem) // half * half
        step = _coll_step(coll, mine, 1.0 / half)
        dev = b.get_device()
        x2 = self._tensor(np.random.default_rng(0).random(2 * elems)
                          .astype(np.float32), n, r)
        both = Chain([(step, x2)], world=b.get_default_group(), device=dev)
        single = None
        if r < half:
            x1 = self._tensor(np.random.default_rng(0).random(elems)
                              .astype(np.float32), half, r)
            single = Chain([(step, x1)], world=mine, device=dev)
        return [single, both]

    def run_split_pgs(self, coll: str, size_bytes: int,
                      n_hi: int = 16) -> OverlapResult:
        """Both half-world groups at once against the first half alone;
        1.0 means the two groups do not interfere.  The time is rank 0's
        (the second half's ranks report their own, of the concurrent run
        only)."""
        single, both = self.split_pgs_chains(coll, size_bytes)
        t_single = single.time_us(n_hi) if single is not None else 0.0
        self.backend.barrier()
        t_both = both.time_us(n_hi)
        if single is None:
            t_single = t_both
        return OverlapResult((t_single, t_single), t_both)

    def report(self, colls, size_bytes, res: OverlapResult, mode: str):
        """Each collective's solo and overlapped busBW (on rank 0)."""
        if self.backend.get_global_rank() != 0:
            return
        if isinstance(colls, str):
            colls = [colls]
        n = self.backend.get_world_size()
        solo_bw = [alg_bw(size_bytes, t) * bus_bw_factor(c, n)
                   for c, t in zip(colls, res.solo_us)]
        # in the overlapped run every collective finished within t_both
        olap_bw = [alg_bw(size_bytes, res.t_both_us) * bus_bw_factor(c, n)
                   for c in colls]
        solos = " ".join(f"t({c})={t:.1f}us"
                         for c, t in zip(colls, res.solo_us))
        bws = " ".join(f"busBW({c})={s:.2f}/{o:.2f}"
                       for c, s, o in zip(colls, solo_bw, olap_bw))
        print(f"OVERLAP-RES mode={mode} {'+'.join(colls)} size={size_bytes}B "
              f"{solos} tAll={res.t_both_us:.1f}us "
              f"eff={res.overlap_efficiency:.1%} {bws} "
              f"overlapped busBW sum={sum(olap_bw):.2f} GB/s", flush=True)


class CommsComputeBench:
    """Collective x compute overlap (PARAM's ``commsComputeBench``): a step
    posts one collective and runs ``num_compute`` compute kernels while it
    is in flight."""

    def __init__(self, backend: Backend, dtype: str = "float32"):
        self.backend = backend
        self.dtype = dtype_from_name(dtype)
        self.elem = dtype_size(self.dtype)

    def chains(self, collective: str = "all_reduce",
               size_bytes: int = 1 << 20, kernel: str = "gemm",
               mm_dim: int = 1024, num_compute: int = 1,
               emb_rows: int = 100_000, emb_dim: int = 128,
               emb_batch: int = 2048, emb_nnz: int = 30) -> Dict[str, Chain]:
        """{"comm", "compute", "both"} chains on the reference's data
        (``default_rng(0)``: the collective's global array, then the GEMM
        operand or the table and ids, replicated on every rank)."""
        b = self.backend
        n, r = b.get_world_size(), b.get_global_rank()
        dev = b.get_device()
        elems = max(n, size_bytes // self.elem) // n * n
        rng = np.random.default_rng(0)
        x = torch.from_numpy(_rank_slice(rng.random(elems).astype(np.float32),
                                         n, r).copy()).to(dev).to(self.dtype)
        if kernel == "gemm":
            ca = torch.from_numpy((rng.random((mm_dim, mm_dim)) * 0.01)
                                  .astype(np.float32)).to(dev).to(self.dtype)

            def compute(i):
                out = ca + float(np.float32(i) * np.float32(1e-6))
                for _ in range(num_compute):
                    out = torch.matmul(out.float(), ca.float()).to(ca.dtype)
                return out.float().sum()

        elif kernel == "emb_lookup":
            from param_tpu_torch.ops.embedding import embedding_bag

            table = torch.from_numpy(rng.random((emb_rows, emb_dim),
                                                dtype=np.float32)).to(dev) \
                .to(self.dtype)
            idx = torch.from_numpy(rng.integers(
                0, emb_rows, size=(emb_batch, emb_nnz)).astype(np.int32)) \
                .to(dev)

            def compute(i):
                shifted = (idx + i) % emb_rows
                s = embedding_bag(table, shifted).float().sum()
                for _ in range(num_compute - 1):
                    s = s + embedding_bag(table, (shifted + 1) % emb_rows) \
                        .float().sum()
                return s

        elif kernel in ("d2h", "h2d"):
            compute = self._host_transfer(kernel, elems // n, num_compute)
        else:
            raise ValueError(f"unsupported kernel {kernel!r}")
        step = _coll_step(collective, b.get_default_group(), 1.0 / n)
        world = b.get_default_group()
        return {"comm": Chain([(step, x)], world=world, device=dev),
                "compute": Chain([], compute, world=world, device=dev),
                "both": Chain([(step, x)], compute, world=world, device=dev)}

    def _host_transfer(self, kernel: str, local: int, num_compute: int):
        """The 'compute' of ``d2h`` / ``h2d``: ``num_compute`` copies a step
        of ``local`` f32 between the card and 4 distinct pinned host
        buffers (``non_blocking``), cycling through them; ``h2d`` adds the
        pushed buffer's sum to the checksum, ``d2h`` one element of the
        fetched one."""
        dev = self.backend.get_device()
        on_card = dev.type == "cuda"
        rng = np.random.default_rng(1)
        host = [torch.from_numpy(rng.random(local).astype(np.float32))
                for _ in range(4)]
        if on_card:
            host = [h.pin_memory() for h in host]
        card = host[0].to(dev)
        k = [0]

        def compute(i):
            s = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(num_compute):
                h = host[k[0] % len(host)]
                if kernel == "h2d":
                    card.copy_(h, non_blocking=True)
                    s = s + card.sum()
                else:
                    h.copy_(card, non_blocking=True)
                    s = s + card[i % local]
                k[0] += 1
            return s

        return compute

    def run(self, collective: str = "all_reduce", size_bytes: int = 1 << 20,
            kernel: str = "gemm", mm_dim: int = 1024, num_compute: int = 1,
            emb_rows: int = 100_000, emb_dim: int = 128,
            emb_batch: int = 2048, emb_nnz: int = 30,
            n_hi: int = 16) -> Dict:
        c = self.chains(collective, size_bytes, kernel, mm_dim, num_compute,
                        emb_rows, emb_dim, emb_batch, emb_nnz)
        t_comm = c["comm"].time_us(n_hi)
        t_comp = c["compute"].time_us(n_hi)
        t_both = c["both"].time_us(n_hi)
        lo = min(t_comm, t_comp)
        saved = t_comm + t_comp - t_both
        eff = max(0.0, min(1.0, saved / lo)) if lo > 0 else 0.0
        n = self.backend.get_world_size()
        out = {
            "collective": collective,
            "kernel": kernel,
            "size_bytes": size_bytes,
            "t_comm_us": t_comm,
            "t_compute_us": t_comp,
            "t_both_us": t_both,
            "overlap_efficiency": eff,
            "bus_bw_gbs": alg_bw(size_bytes, t_both)
            * bus_bw_factor(collective, n),
        }
        if kernel == "gemm":
            out["tflops"] = 2 * mm_dim ** 3 * num_compute / (t_both * 1e-6) \
                / 1e12
        elif kernel in ("d2h", "h2d"):
            out["host_link_gbs"] = size_bytes * num_compute / max(
                t_comp * 1e-6, 1e-12) / 1e9
        return out

    def report(self, r: Dict) -> None:
        if self.backend.get_global_rank() != 0:
            return
        extra = f" TF/s={r['tflops']:.2f}" if "tflops" in r else ""
        if "host_link_gbs" in r:
            extra += f" hostBW={r['host_link_gbs']:.2f} GB/s"
        print(f"COMMS-COMPUTE-RES {r['collective']}+{r['kernel']} "
              f"size={r['size_bytes']}B comm={r['t_comm_us']:.1f}us "
              f"compute={r['t_compute_us']:.1f}us both={r['t_both_us']:.1f}us "
              f"eff={r['overlap_efficiency']:.1%} "
              f"busBW={r['bus_bw_gbs']:.2f} GB/s{extra}", flush=True)
