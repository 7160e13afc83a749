"""The port's headline benchmark: sum-pooled EmbeddingBag lookup bandwidth
on one card (the port of the root ``bench.py``).  Prints ONE JSON line.

Shape: one 1M x 128 f32 table made on the card from a seeded
``torch.Generator``, batch 8192, nnz 30, sum pooling, through
``ops.embedding.embedding_bag`` (K1 on the card).  Value: ``bench.py``'s
bytes, ``embedding_bytes(B, nnz, D, 4)`` (one table row per lookup), over
the time per lookup.  Time: CUDA events around CUDA-graph replays of
``--iters`` lookups, the median of 5 windows after one untimed window; the
ids are shifted every call (8 shifts of one seeded draw, cycled), so no
call repeats its neighbour's rows.  One lookup is first checked against
the plain version.

    python -m param_tpu_torch.bench                                # the card
    python -m param_tpu_torch.bench --device cpu --rows 4096 --batch 64

Without a card it raises unless ``--device cpu`` is given; then it runs the
plain version on the host clock, and its number is no device metric.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import time
from typing import List, Optional

import numpy as np
import torch

from param_tpu_torch.kernels.emb_gather import emb_gather_plain
from param_tpu_torch.ops.embedding import embedding_bag, embedding_bytes
from param_tpu_torch.utils.chip import nvidia_smi_name_power
from param_tpu_torch.utils.device import require_sm90, resolve_device
from param_tpu_torch.utils.timer import time_samples

ROWS, DIM, BATCH, NNZ = 1_000_000, 128, 8192, 30
N_SHIFTS = 8


def metric_name(rows: int, batch: int) -> str:
    """``torch_emb_lookup_bw_1Mx128_b8192_nnz30`` at the default shape."""
    if rows % 1_000_000 == 0:
        r = f"{rows // 1_000_000}M"
    elif rows % 1000 == 0:
        r = f"{rows // 1000}K"
    else:
        r = str(rows)
    return f"torch_emb_lookup_bw_{r}x{DIM}_b{batch}_nnz{NNZ}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m param_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=50,
                    help="lookups per timed window")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        require_sm90(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((args.rows, DIM), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.integers(
        0, args.rows, size=(args.batch, NNZ)).astype(np.int32)).to(dev)
    ids = [((base.long() + i) % args.rows).int() for i in range(N_SHIFTS)]
    nxt = itertools.cycle(ids)
    with torch.no_grad():
        got = embedding_bag(table, ids[0])
        want = emb_gather_plain(table, ids[0])
        err = (got - want).abs().max().item()
        if not err <= 1e-5 * want.abs().max().item():
            raise RuntimeError(f"the lookup differs from the plain version "
                               f"by {err:.3e}")
        t = time_samples(lambda: embedding_bag(table, next(nxt)), args.iters,
                         dev, reps=5, graph=dev.type == "cuda")
    per_s = statistics.median(t) / 1e3
    nbytes = embedding_bytes(args.batch, NNZ, DIM, 4)
    smi = nvidia_smi_name_power(dev.index or 0) if dev.type == "cuda" else None
    print(json.dumps({
        "metric": metric_name(args.rows, args.batch),
        "value": nbytes / per_s / 1e9,
        "unit": "GB/s",
        "detail": {
            "path": "K1 (emb_gather.cu)" if dev.type == "cuda"
                    else "plain version on the host",
            "us_per_step": per_s * 1e6,
            "us_per_step_min": min(t) * 1e3,
            "us_per_step_max": max(t) * 1e3,
            "lookups_per_s": args.batch * NNZ / per_s,
            "bytes_per_step": nbytes,
            "max_abs_err": err,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu",
            "power_limit": smi.split(",")[-1].strip() if smi else None,
            "iters": args.iters, "windows": len(t),
            "wall_s": time.perf_counter() - t0,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
