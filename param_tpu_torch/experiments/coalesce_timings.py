"""K10, the block-coalesced embedding bag, at the coalesced-fetch
experiment's stage-B shape, with what a profile of the card can say.

For uniform and zipf ids (stage B's: table 1,048,576 x 128 f32, 8192 bags
x nnz 32, r_blk 8, 16 bags a tile, 8 shifted copies of the ids cycled),
this prints one JSON line per distribution:

- ``call``: the whole ``coalesced_bag`` call (one K10 launch),
  CUDA-graph replays (median and spread of 5 windows of ``--iters``
  calls), and issued eagerly;
- ``profile``: ``torch.profiler``'s device time a call by kernel name over
  10 calls;
- ``tiles``: the graph-replay ms of the whole call at 1, 2 and 3 tiles an
  SM and at all 512 tiles (the first bags of the same ids), which shows a
  tail wave as a step between multiples of the resident blocks;
- ``F.embedding_bag`` and K1 at the same ids, the scheme's block count
  (``coalesce_plan``), both byte bounds (the bags' distinct rows; the
  scheme's blocks in full) and the fetch rate over the scheme's bytes;
- the card's name and power limit;

then a line with the kernels' registers and shared memory (ptxas).

    python -m param_tpu_torch.experiments.coalesce_timings
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from param_tpu_torch.experiments import coalesce as coal
from param_tpu_torch.kernels import build
from param_tpu_torch.kernels import coalesce as kc
from param_tpu_torch.kernels.emb_gather import emb_gather_cuda
from param_tpu_torch.utils.chip import bound_ms, nvidia_smi_name_power
from param_tpu_torch.utils.device import require_sm90, resolve_device
from param_tpu_torch.utils.profiler import kernel_times
from param_tpu_torch.utils.timer import time_samples


def spread(samples: List[float]) -> dict:
    return dict(ms=statistics.median(samples), min=min(samples),
                max=max(samples))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m param_tpu_torch.experiments.coalesce_timings",
        description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20,
                    help="calls per timed window")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    require_sm90(dev)
    smi = nvidia_smi_name_power(dev.index or 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table = torch.rand((coal.E, coal.D), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    rpt = coal.TILE_BAGS * coal.NNZ
    for dist in ("uniform", "zipf"):
        idx = coal.stage_b_ids(rng, dist)
        ids = coal._shifts(torch.from_numpy(idx).to(dev), coal.E)

        def call(bags=coal.B, it=itertools.cycle(ids)):
            return kc.coalesced_bag(table, next(it)[:bags], coal.R_BLK,
                                    coal.TILE_BAGS)

        def graph_ms(fn):
            return spread(time_samples(fn, args.iters, reps=5, graph=True))

        with torch.no_grad():
            rec = dict(dist=dist, card=smi)
            rec["call"] = graph_ms(call)
            rec["call_eager"] = spread(time_samples(call, args.iters, reps=5))
            rec["profile_ms"], rec["profile"] = kernel_times(call)
            rec["tiles"] = {t: graph_ms(lambda t=t: call(t * coal.TILE_BAGS))
                            ["ms"] for t in (sms, 2 * sms, 3 * sms,
                                             coal.B // coal.TILE_BAGS)}
            longs = itertools.cycle([i.long() for i in ids])
            rec["embedding_bag"] = graph_ms(
                lambda: F.embedding_bag(next(longs), table, mode="sum"))
            k1_ids = itertools.cycle(ids)
            rec["k1"] = graph_ms(lambda: emb_gather_cuda(table, next(k1_ids)))
        blocks = int(kc.coalesce_plan(ids[0], coal.E, coal.R_BLK,
                                      coal.TILE_BAGS).n_blocks.sum())
        rows = torch.unique(ids[0]).numel()
        ends = ids[0].numel() * 4 + coal.B * coal.D * 4  # ids in, bags out
        scheme_bytes = blocks * coal.R_BLK * coal.D * 4
        rec.update(
            blocks=blocks, blocks_per_tile=blocks / (coal.B // coal.TILE_BAGS),
            ids_per_tile=rpt, distinct_rows=rows,
            bound_rows_ms=bound_ms(rows * coal.D * 4 + ends)[0],
            bound_scheme_ms=bound_ms(scheme_bytes + ends)[0],
            scheme_gbps=scheme_bytes / rec["call"]["ms"] / 1e6)
        print(json.dumps(rec), flush=True)
        del ids
        torch.cuda.empty_cache()
    print(json.dumps({"ptxas": build.kernel_resources("coalesce"),
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
