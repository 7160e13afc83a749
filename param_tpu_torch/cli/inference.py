"""MLP inference bench CLI (port of ``param_tpu/cli/inference.py``).

Same flags as the reference plus ``--device`` (default ``cuda``).  ``--dtype
int4`` runs every layer through the int4 kernel K5; ``--chain N`` forwards
make one timed window and ``--reps R`` windows are taken (median reported).

Run:
    python -m param_tpu_torch.cli.inference --shape 18,4096,4096,4096,512 --dtype int4
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="param_tpu_torch.inference",
        description="PARAM MLP inference bench, PyTorch/CUDA port")
    ap.add_argument("--dataset", default="A", choices=["A"])
    ap.add_argument("--shape", default=None,
                    help="explicit layers,din,hidden,dout,batch")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float16", "int8", "int4"])
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain versions)")
    ap.add_argument("--log", default="INFO")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    logging.basicConfig(level=ns.log.upper())
    from param_tpu_torch.ops import datasets
    from param_tpu_torch.ops.compute_bench import print_results
    from param_tpu_torch.ops.inference import bench_inference
    from param_tpu_torch.utils.device import resolve_device

    dev = resolve_device(ns.device)
    configs = ([tuple(int(x) for x in ns.shape.split(","))] if ns.shape
               else datasets.MLP_DATASETS[ns.dataset])
    results = bench_inference(configs, dtype=ns.dtype, iters=ns.chain,
                              reps=ns.reps, device=dev)
    print_results(results, ns.dtype, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
