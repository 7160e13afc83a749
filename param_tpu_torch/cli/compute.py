"""Compute bench CLI, subcommands gemm | emb | linear (port of
``param_tpu/cli/compute.py``).

Same subcommands and flags as the reference plus ``--device`` (default
``cuda``).  ``--chain N`` is the number of calls in one timed window and
``--reps R`` the number of windows (the median is reported).  The
attention, decode, serve and transformer benches are not ported yet
(ROADMAP queue 1 item 9) and raise ``NotImplementedError``.

Run:
    python -m param_tpu_torch.cli.compute gemm --dataset A --dtype bfloat16 --pallas
    python -m param_tpu_torch.cli.compute gemm --dataset C --compare
    python -m param_tpu_torch.cli.compute gemm --weight-resident 8 --shape 128,4096,4096 --dtype bfloat16
    python -m param_tpu_torch.cli.compute emb --dataset baseline
    python -m param_tpu_torch.cli.compute linear --shape 18,1024,1024,1024,512
"""

from __future__ import annotations

import argparse
import logging
import sys

_UNPORTED = ("attention", "decode", "serve", "transformer")
_NOT_PORTED = ("is not ported yet (ROADMAP queue 1 item 9: transformer "
               "tier, attention kernels K6/K7)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="param_tpu_torch.compute",
        description="PARAM compute benchmarks, PyTorch/CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gemm", help="matmul sweep")
    g.add_argument("--dataset", default="A", choices=["A", "B", "C"])
    g.add_argument("--shape", default=None,
                   help="explicit M,N,K (overrides --dataset)")
    g.add_argument("--dtype", default="float32")
    g.add_argument("--pallas", action="store_true",
                   help="use the hand-written tiled GEMM kernel K3 (the "
                        "name is the reference's)")
    g.add_argument("--weight-resident", type=int, default=0, metavar="S",
                   help="time S GEMMs sharing one weight, kept in L2 by the "
                        "kernel K4, and report per-GEMM numbers")
    g.add_argument("--compare", action="store_true",
                   help="run both torch.matmul and K3 per shape, printed "
                        "side by side")
    g.add_argument("--precision", default="default",
                   choices=["default", "highest"],
                   help="kept for the reference's command lines: both mean "
                        "full f32 here (TF32 off)")
    g.add_argument("--chain", type=int, default=16)
    g.add_argument("--reps", type=int, default=2)

    e = sub.add_parser("emb", help="EmbeddingBag sweep")
    e.add_argument("--dataset", default="baseline",
                   choices=["A", "B", "baseline"])
    e.add_argument("--shape", default=None,
                   help="explicit rows,dim,nnz,batch (overrides --dataset)")
    e.add_argument("--dtype", default="float32")
    e.add_argument("--distribution", default="uniform",
                   choices=["uniform", "zipf"])
    e.add_argument("--max-rows", type=int, default=0,
                   help="clamp table rows (device memory limit)")
    e.add_argument("--chain", type=int, default=8)
    e.add_argument("--reps", type=int, default=2)

    lin = sub.add_parser("linear", help="MLP train/inference bench")
    lin.add_argument("--dataset", default="A", choices=["A"])
    lin.add_argument("--shape", default=None,
                     help="explicit layers,din,hidden,dout,batch")
    lin.add_argument("--dtype", default="float32")
    lin.add_argument("--optimizer", default="sgd", choices=["sgd", "adagrad"])
    lin.add_argument("--fwd-only", action="store_true", help="inference mode")
    lin.add_argument("--chain", type=int, default=8)
    lin.add_argument("--reps", type=int, default=2)

    for name in _UNPORTED:  # any flags are accepted, then refused
        sub.add_parser(name, help="not ported yet")

    # the common flags go before or after the subcommand
    for parser, top in [(ap, True)] + [(p, False) for p in sub.choices.values()]:
        parser.add_argument("--profile", metavar="DIR",
                            default=None if top else argparse.SUPPRESS,
                            help="trace the bench with torch.profiler into DIR")
        parser.add_argument("--device",
                            default="cuda" if top else argparse.SUPPRESS,
                            help="cuda (hand-written kernels) or cpu (plain "
                                 "versions)")
        parser.add_argument("--log", default="INFO" if top else argparse.SUPPRESS)
    return ap


def _shapes(ns, table):
    if ns.shape:
        return [tuple(int(x) for x in ns.shape.split(","))]
    return table[ns.dataset]


def main(argv=None) -> int:
    ap = build_parser()
    ns, unknown = ap.parse_known_args(argv)
    if ns.cmd in _UNPORTED:
        raise NotImplementedError(f"the {ns.cmd} bench {_NOT_PORTED}")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    logging.basicConfig(level=ns.log.upper())

    from param_tpu_torch.ops import datasets
    from param_tpu_torch.ops.compute_bench import (
        bench_emb, bench_gemm, bench_mlp, print_results,
    )
    from param_tpu_torch.utils.device import resolve_device
    from param_tpu_torch.utils.profiler import profile_to

    dev = resolve_device(ns.device)
    with profile_to(ns.profile, dev):
        if ns.cmd == "gemm" and ns.compare:
            print("-" * 64)
            print(f"{'M':>10} {'N':>10} {'K':>10} {'path':>8} "
                  f"{'Time(us)':>12} {'Rate(TF/s)':>12}")
            print("-" * 64)
            for m, n, k in _shapes(ns, datasets.GEMM_DATASETS):
                for use_kernel, label in ((False, "torch"), (True, "K3")):
                    r = bench_gemm([(m, n, k)], dtype=ns.dtype,
                                   iters=ns.chain, reps=ns.reps,
                                   use_pallas=use_kernel,
                                   precision=ns.precision, device=dev)[0]
                    print(f"{m:>10} {n:>10} {k:>10} {label:>8} "
                          f"{r.lat_us:>12.1f} {r.tflops:>12.3f}")
            return 0
        if ns.cmd == "gemm":
            results = bench_gemm(
                _shapes(ns, datasets.GEMM_DATASETS), dtype=ns.dtype,
                iters=ns.chain, reps=ns.reps, use_pallas=ns.pallas,
                precision=ns.precision, weight_resident=ns.weight_resident,
                device=dev)
        elif ns.cmd == "emb":
            results = bench_emb(
                _shapes(ns, datasets.EMB_DATASETS), dtype=ns.dtype,
                iters=ns.chain, reps=ns.reps, distribution=ns.distribution,
                max_rows=ns.max_rows or None, device=dev)
        else:
            results = bench_mlp(
                _shapes(ns, datasets.MLP_DATASETS), dtype=ns.dtype,
                optimizer=ns.optimizer, fwd_only=ns.fwd_only, iters=ns.chain,
                reps=ns.reps, device=dev)
    print_results(results, ns.dtype, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
