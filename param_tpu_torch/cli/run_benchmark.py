"""Operator micro-benchmark CLI (port of ``param_tpu/cli/run_benchmark.py``).

Counterpart of the reference's ``train/compute/python/pytorch/
run_benchmark.py:24-365``.  The JAX package's flags plus ``--device``
(default ``cuda``); its ``--xla-dump`` has no counterpart (no XLA here).

Run:
    python -m param_tpu_torch.cli.run_benchmark -c configs/basic_ops.json \
        -o results.jsonl -b
    python -m param_tpu_torch.cli.run_benchmark -c configs/basic_ops.json --device cpu
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="param_tpu_torch.run_benchmark",
        description="PARAM operator micro-benchmark, PyTorch/CUDA port",
    )
    ap.add_argument("-c", "--config", default=None, help="benchmark config JSON")
    ap.add_argument("--list-ops", action="store_true",
                    help="list registered operators and exit")
    ap.add_argument("-o", "--output", default=None, help="JSON-lines output path")
    ap.add_argument("-a", "--append", action="store_true",
                    help="append to output (reference --append)")
    ap.add_argument("-b", "--backward", action="store_true",
                    help="also measure backward pass")
    ap.add_argument("-w", "--warmup", type=int, default=1)
    ap.add_argument("-i", "--iters", type=int, default=10)
    ap.add_argument("--mode", default="chain", choices=["chain", "discrete"])
    ap.add_argument("--resume-op-run-id", default=None)
    ap.add_argument("--stop-op-run-id", default=None)
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="one torch.profiler trace per (op run, pass); "
                         "per-kernel device times land in each record "
                         "(the NCU/NSYS orchestration analogue)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain versions)")
    ap.add_argument("--log", default="INFO")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    logging.basicConfig(level=ns.log.upper())
    if ns.list_ops:
        from param_tpu_torch.microbench.operator import load_workloads, op_map

        load_workloads()
        print("\n".join(sorted(op_map)))
        return 0
    if not ns.config:
        print("error: -c/--config is required (or --list-ops)")
        return 2
    from param_tpu_torch.microbench.benchmark import (
        Benchmark, BenchmarkConfig, RunOptions,
    )

    cfg = BenchmarkConfig.load_json_file(ns.config)
    stream = None
    if ns.output:
        stream = open(ns.output, "a" if ns.append else "w")
    try:
        options = RunOptions(
            warmup=ns.warmup,
            iters=ns.iters,
            passes="forward,backward" if ns.backward else "forward",
            mode=ns.mode,
            device=ns.device,
            resume_op_run_id=ns.resume_op_run_id,
            stop_op_run_id=ns.stop_op_run_id,
            out_stream=stream,
            profile_dir=ns.profile_dir,
        )
        results = Benchmark(cfg, options).run()
    finally:
        if stream:
            stream.close()
    for r in results:
        line = {k: v for k, v in r.items() if k != "config"}
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
