"""CLI for comm-trace replay (the port's ``param_tpu.cli.replay``; flags
after PARAM's ``commsTraceReplay.py``).

One process per rank, launched by torchrun (without it, a world of one);
NCCL on the card, gloo with ``--device cpu``; ``--backend mock`` needs
neither (a dry run, or a replay of no-ops).  Rank 0 prints the report as
JSON:

    python -m param_tpu_torch.cli.comms --collective all_reduce \\
        --trace-dump comms.json
    python -m param_tpu_torch.cli.replay --trace-path comms.json --blocking
    torchrun --nproc-per-node 8 -m param_tpu_torch.cli.replay -- \\
        --trace-path comms.json --dry-run
    python -m param_tpu_torch.cli.replay --trace-path et.json \\
        --trace-type pytorch_et --device cpu
    python -m param_tpu_torch.cli.et capture --workload dlrm -o et.json.gz
    python -m param_tpu_torch.cli.replay --trace-path et.json.gz \\
        --trace-type et --backend mock

``--trace-type et`` replays the comm ops of an execution trace: one the
port captured (``cli.et capture``) or one of the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="param_tpu_torch.replay",
                                 description="PARAM comm trace replay on "
                                             "torch.distributed")
    ap.add_argument("--trace-path", required=True)
    ap.add_argument("--trace-type", default="basic",
                    choices=["basic", "pytorch_et", "kineto", "et"],
                    help="basic JSON | PyTorch/Chakra host ET | Kineto "
                         "unitrace with comms metadata | et (an execution "
                         "trace's comm ops)")
    ap.add_argument("--target-rank", type=int, default=0,
                    help="rank whose comm stream to extract from per-rank "
                         "pytorch_et/kineto traces")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--num-replays", "--r", type=int, default=1)
    ap.add_argument("--num-warmup-replays", type=int, default=1)
    ap.add_argument("--no-warm-up", action="store_true")
    ap.add_argument("--blocking", "--z", action="store_true")
    ap.add_argument("--auto-shrink", action="store_true")
    ap.add_argument("--rebalance-policy", default=None,
                    choices=[None, "equal"])
    ap.add_argument("--use-timestamp", action="store_true")
    ap.add_argument("--output-path", default=None,
                    help="per-op details JSON (rank r > 0 adds .rank<r>)")
    ap.add_argument("--analyze", action="store_true",
                    help="print the post-hoc busBW analysis after replay")
    ap.add_argument("--backend", default="dist",
                    choices=["dist", "torchcomms", "mock"])
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
    from param_tpu_torch.backend import get_backend_cls
    from param_tpu_torch.trace.replay import CommsReplay, ReplayParams

    cls = get_backend_cls(ns.backend)
    backend = cls() if ns.backend == "mock" else cls(ns.device)
    backend.initialize()
    try:
        replay = CommsReplay(backend, ReplayParams(
            trace_path=ns.trace_path, trace_type=ns.trace_type,
            target_rank=ns.target_rank, dry_run=ns.dry_run,
            num_replays=ns.num_replays,
            num_warmup_replays=ns.num_warmup_replays,
            do_warmup=not ns.no_warm_up, blocking=ns.blocking,
            auto_shrink=ns.auto_shrink,
            rebalance_policy=ns.rebalance_policy,
            use_timestamp=ns.use_timestamp, output_path=ns.output_path))
        result = replay.run()
        if backend.get_global_rank() == 0:
            print(json.dumps(result, indent=2, default=str))
            if ns.analyze and replay.records:
                from param_tpu_torch.trace.profiler_analysis import (
                    analyze_records, print_summary,
                )

                print_summary(analyze_records(
                    [{"comms": r.comms, "size_bytes": r.size_bytes,
                      "lat_us": r.lat_us} for r in replay.records],
                    backend.get_world_size()))
    finally:
        backend.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
