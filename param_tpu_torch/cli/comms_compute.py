"""CLI for the comms + compute overlap benchmark (the port's
``param_tpu.cli.comms_compute``; flags after PARAM's
``commsComputeBench.py``: ``--kernel``, ``--mm-dim``, ``--num-compute``
and the embedding kernel's sizes).

One process per rank, launched by torchrun (without it, a world of one);
NCCL on the card, gloo with ``--device cpu``.  ``--kernel emb_lookup``
runs K1 on the card.  Rank 0 prints one COMMS-COMPUTE-RES line per size:

    torchrun --nproc-per-node 8 -m param_tpu_torch.cli.comms_compute -- \\
        --collective all_reduce --kernel gemm --mm-dim 1024 --b 1M
    python -m param_tpu_torch.cli.comms_compute --device cpu --mm-dim 64
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="param_tpu_torch.comms_compute",
                                 description="PARAM comms + compute overlap "
                                             "benchmark on torch.distributed")
    ap.add_argument("--collective", default="all_reduce")
    ap.add_argument("--kernel", default="gemm",
                    choices=["gemm", "emb_lookup", "d2h", "h2d"])
    ap.add_argument("--mm-dim", type=int, default=1024)
    ap.add_argument("--num-compute", type=int, default=1,
                    help="compute kernels per iteration")
    ap.add_argument("--emb-rows", type=int, default=100_000)
    ap.add_argument("--emb-dim", type=int, default=128)
    ap.add_argument("--emb-batch", type=int, default=2048)
    ap.add_argument("--emb-nnz", type=int, default=30)
    ap.add_argument("--b", default="1M", help="collective message size")
    ap.add_argument("--e", default=None, help="end size (sweep if set)")
    ap.add_argument("--f", type=int, default=4)
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
    from param_tpu_torch.comms.overlap_bench import CommsComputeBench
    from param_tpu_torch.utils.sizes import parse_size, size_sweep

    backend = DistBackend(ns.device)
    backend.initialize()
    try:
        bench = CommsComputeBench(backend, dtype=ns.data_type)
        begin = parse_size(ns.b)
        sizes = size_sweep(begin, parse_size(ns.e), ns.f) if ns.e else [begin]
        for size in sizes:
            bench.report(bench.run(
                collective=ns.collective, size_bytes=size, kernel=ns.kernel,
                mm_dim=ns.mm_dim, num_compute=ns.num_compute,
                emb_rows=ns.emb_rows, emb_dim=ns.emb_dim,
                emb_batch=ns.emb_batch, emb_nnz=ns.emb_nnz, n_hi=ns.chain))
    finally:
        backend.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
