"""The coalesced-fetch experiment on the card (port of
``scripts/coalesce_experiment.py``; kernels K9 and K10).

The embedding gather fetches one random table row (512 bytes at D = 128)
per lookup.  This experiment tests the "copy-count" lever: fetch k
consecutive rows with ONE copy, so whatever a copy costs to issue is shared
by k rows while the bytes stay the same.

- Stage A (K9, ``kernels.coalesce.desc_fetch``): the same K_ROWS rows
  fetched as K_ROWS / k copies of k rows, k in {1, 2, 4, 8, 16, 32}.  If
  the time is n_copies * t_copy + bytes / rate with a flat t_copy, the
  lever is real.
- Stage B (K10, ``kernels.coalesce.coalesced_bag``): the sum-pooled bag
  through a per-tile sort and block dedup and one copy per distinct aligned
  ``r_blk``-row block, all in one K10 launch on the card, against K1 at the
  same ids, under uniform and zipf ids; ``F.embedding_bag`` is printed
  beside it.

Sizes are the script's: table 1,048,576 x 128 f32 (512 MiB on the card),
B 8192, nnz 32, K_ROWS 262,144, 4096 rows a tile for stage A, r_blk 8 and
16 bags a tile for stage B.  Starts and ids are shifted every call (8
precomputed shifts, cycled).  Timing: CUDA events over CUDA-graph replays,
the median of 5 windows (``utils/timer``); on the CPU the plain versions
on the host clock, which says nothing of the card.

    python -m param_tpu_torch.experiments.coalesce            # stages A, B
    python -m param_tpu_torch.experiments.coalesce --verify   # kernels only
    python -m param_tpu_torch.experiments.coalesce --device cpu \\
        --num-rows 4096 --batch 64 --rows-per-tile 1024 --iters 2
"""

from __future__ import annotations

import argparse
import itertools
import statistics
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from param_tpu_torch.kernels import coalesce as kc
from param_tpu_torch.kernels.emb_gather import emb_gather
from param_tpu_torch.models.dlrm_data import gen_indices
from param_tpu_torch.utils.chip import nvidia_smi_name_power
from param_tpu_torch.utils.device import require_sm90, resolve_device
from param_tpu_torch.utils.timer import time_samples

B, NNZ, E, D = 8192, 32, 1_048_576, 128
K_ROWS = B * NNZ  # 262144 fetched rows
KS = (1, 2, 4, 8, 16, 32)
ROWS_PER_TILE = 4096
R_BLK, TILE_BAGS = 8, 16
N_SHIFTS = 8


def _shifts(x: torch.Tensor, modulus: int) -> List[torch.Tensor]:
    """``(x + i) % modulus`` for i < N_SHIFTS, int32, on x's device."""
    return [((x.long() + i) % modulus).int() for i in range(N_SHIFTS)]


def stage_b_ids(rng: np.random.Generator, dist: str, batch: int = B,
                rows: int = E) -> np.ndarray:
    """Stage B's (batch, NNZ) int32 ids over ``rows`` rows, ``uniform`` or
    ``zipf``, drawn from ``rng``."""
    if dist == "uniform":
        idx = rng.integers(0, rows, size=(batch, NNZ))
    else:
        idx = gen_indices(rng, batch, 1, NNZ, rows, "zipf")[:, 0, :]
    return np.ascontiguousarray(idx, dtype=np.int32)


def _time(fn, iters: int, dev: torch.device) -> dict:
    """ms per call: median, min and max over 5 windows (CUDA-graph replays
    on the card)."""
    t = time_samples(fn, iters, dev, reps=5, graph=dev.type == "cuda")
    return dict(ms=statistics.median(t), min=min(t), max=max(t))


def _fmt(t: dict) -> str:
    return f"{t['ms']:8.4f} ms ({t['min']:.4f}-{t['max']:.4f})"


def stage_a(table: torch.Tensor, k_rows: int, rows_per_tile: int,
            iters: int) -> None:
    """Time per copy against rows per copy (``coalesce_experiment.py:125``)."""
    print("=== stage A: time per copy vs rows per copy k (K9) ===")
    rng = np.random.default_rng(0)
    dev, rows = table.device, table.shape[0]
    for k in KS:
        n_copies = k_rows // k
        starts = torch.from_numpy(rng.integers(
            0, rows - k, size=(n_copies,)).astype(np.int32)).to(dev)
        nxt = itertools.cycle(_shifts(starts, rows - k))
        t = _time(lambda: kc.desc_fetch(table, next(nxt), k, rows_per_tile),
                  iters, dev)
        per_s = t["ms"] / 1e3
        print(f"  K={k:3d}: {_fmt(t)}  "
              f"{k_rows * table.shape[1] * 4 / per_s / 1e9:7.1f} GB/s  "
              f"{per_s / n_copies * 1e9:7.2f} ns/copy  "
              f"({k_rows / per_s / 1e6:7.1f} M rows/s)")


def stage_b(table: torch.Tensor, batch: int, iters: int) -> None:
    """The bag through K10 against K1 (``coalesce_experiment.py:277``)."""
    print("=== stage B: end-to-end bag lookup, coalesced (one K10 launch) "
          "vs K1 ===")
    rng = np.random.default_rng(0)
    dev, rows = table.device, table.shape[0]
    rpt = TILE_BAGS * NNZ
    for dist in ("uniform", "zipf"):
        idx = stage_b_ids(rng, dist, batch, rows)
        bl = np.sort(idx.reshape(-1, rpt), axis=1) // R_BLK
        distinct = float((np.diff(bl, axis=1) != 0).sum(axis=1).mean() + 1)
        print(f"  [{dist}] distinct {R_BLK}-row blocks per {rpt}-row tile: "
              f"{distinct:.1f} (coalesce factor {rpt / distinct:.2f}x, "
              f"bytes amplification {distinct * R_BLK / rpt:.2f}x)")
        ids = _shifts(torch.from_numpy(idx).to(dev), rows)
        n_ids, n_ids2 = itertools.cycle(ids), itertools.cycle(ids)
        n_long = itertools.cycle([i.long() for i in ids])
        with torch.no_grad():
            k1 = _time(lambda: emb_gather(table, next(n_ids)), iters, dev)
            coal = _time(lambda: kc.coalesced_bag(table, next(n_ids2), R_BLK,
                                                  TILE_BAGS), iters, dev)
            lib = _time(lambda: F.embedding_bag(next(n_long), table,
                                                mode="sum"), iters, dev)
        lookups = batch * NNZ
        ratio = k1["ms"] / coal["ms"]
        print(f"  [{dist}] K1: {_fmt(k1)} "
              f"({lookups / k1['ms'] / 1e3:6.1f} M rows/s)   coalesced "
              f"R={R_BLK} (K10): {_fmt(coal)} "
              f"({lookups / coal['ms'] / 1e3:6.1f} M rows/s)   -> "
              f"{'WIN' if coal['ms'] < k1['ms'] else 'LOSS'} {ratio:.2f}x")
        print(f"  [{dist}] F.embedding_bag: {_fmt(lib)}")


def verify(dev: torch.device) -> None:
    """Both kernels against the script's formulas at its ``verify()``
    sizes (``coalesce_experiment.py:328-345``); raises on a mismatch."""
    rng = np.random.default_rng(1)
    e = 4096
    table_np = rng.random((e, D), dtype=np.float32)
    idx_np = rng.integers(0, e, size=(64, 8)).astype(np.int32)
    table = torch.from_numpy(table_np).to(dev)
    got = kc.coalesced_bag(table, torch.from_numpy(idx_np).to(dev), r_blk=8,
                           tile_bags=16)
    np.testing.assert_allclose(got.cpu().numpy(), table_np[idx_np].sum(1),
                               rtol=1e-5)
    starts = rng.integers(0, e - 8, size=(512,)).astype(np.int32)
    out = kc.desc_fetch(table, torch.from_numpy(starts).to(dev), k=8,
                        rows_per_tile=1024)
    want = np.stack([
        np.concatenate([table_np[s:s + 8] for s in starts[j * 128:
                                                          (j + 1) * 128]])
        .sum(0) for j in range(4)])
    np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-4)
    print("verify: both kernels match reference outputs OK")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m param_tpu_torch.experiments.coalesce",
        description="coalesced-fetch experiment (K9 stage A, K10 stage B)")
    ap.add_argument("--verify", action="store_true",
                    help="check both kernels at small sizes and stop")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-rows", type=int, default=E)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--rows-per-tile", type=int, default=ROWS_PER_TILE)
    ap.add_argument("--iters", type=int, default=20,
                    help="calls per timed window")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        require_sm90(dev)
    if args.verify:
        verify(dev)
        return 0
    k_rows = args.batch * NNZ
    if k_rows % args.rows_per_tile or args.batch % TILE_BAGS:
        raise ValueError(f"batch x nnz ({k_rows}) must be a multiple of "
                         f"--rows-per-tile and batch of {TILE_BAGS}")
    card = (nvidia_smi_name_power(dev.index or 0) if dev.type == "cuda"
            else "cpu (plain versions, host clock)")
    print(f"device: {card} | table ({args.num_rows}, {D}) f32, batch "
          f"{args.batch}, nnz {NNZ}, {args.iters} calls a window")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((args.num_rows, D), generator=gen, device=dev)
    stage_a(table, k_rows, args.rows_per_tile, args.iters)
    stage_b(table, args.batch, args.iters)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
