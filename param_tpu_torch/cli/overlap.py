"""CLI for the collective-overlap benchmark (the port's
``param_tpu.cli.overlap``; flags after PARAM's ``commsOverlapBench.py``:
``--collective-pair``, ``--overlap-pair-pgs``).

One process per rank, launched by torchrun (without it, a world of one);
NCCL on the card, gloo with ``--device cpu``.  Rank 0 prints one
OVERLAP-RES line per size:

    torchrun --nproc-per-node 8 -m param_tpu_torch.cli.overlap -- \\
        --collective all_reduce --collective-pair all_to_all --b 1M
    torchrun --nproc-per-node 4 -m param_tpu_torch.cli.overlap -- \\
        --overlap-pair-pgs --collective all_reduce
    python -m param_tpu_torch.cli.overlap --device cpu --b 64K --e 256K
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="param_tpu_torch.overlap",
                                 description="PARAM overlap benchmark on "
                                             "torch.distributed")
    ap.add_argument("--collective", default="all_reduce")
    ap.add_argument("--collective-pair", default=None,
                    help="comma-separated pair collective list run "
                         "concurrently with --collective (defaults to "
                         "--collective)")
    ap.add_argument("--overlap-pair-pgs", action="store_true",
                    help="run the collective concurrently in two half-world "
                         "process groups instead of pairing two collectives")
    ap.add_argument("--b", default="64K", help="begin size")
    ap.add_argument("--e", default="4M", help="end size")
    ap.add_argument("--f", type=int, default=4, help="size step factor")
    ap.add_argument("--data-type", default="float32")
    ap.add_argument("--chain", type=int, default=16,
                    help="steps in a timed window")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank) or cpu (gloo)")
    ap.add_argument("--log", default="INFO")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:  # what torchrun passes on after ``-m ... --``
        argv = argv[1:]
    ns = build_parser().parse_args(argv)
    logging.basicConfig(level=ns.log.upper())
    from param_tpu_torch.backend import DistBackend
    from param_tpu_torch.comms.overlap_bench import OverlapBench
    from param_tpu_torch.utils.sizes import parse_size, size_sweep

    backend = DistBackend(ns.device)
    backend.initialize()
    try:
        bench = OverlapBench(backend, dtype=ns.data_type)
        pair = [c.strip() for c in (ns.collective_pair
                                    or ns.collective).split(",")
                if c.strip()]
        for size in size_sweep(parse_size(ns.b), parse_size(ns.e), ns.f):
            if ns.overlap_pair_pgs:
                res = bench.run_split_pgs(ns.collective, size, n_hi=ns.chain)
                bench.report([ns.collective, ns.collective], size, res,
                             "split-pgs")
            else:
                res = bench.run_same_group(ns.collective, pair, size,
                                           n_hi=ns.chain)
                bench.report([ns.collective] + pair, size, res, "same-group")
    finally:
        backend.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
