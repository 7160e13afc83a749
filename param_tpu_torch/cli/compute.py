"""Compute bench CLI, subcommands gemm | emb | linear | attention | decode |
serve | transformer (port of ``param_tpu/cli/compute.py``).

Same subcommands and flags as the reference plus ``--device`` (default
``cuda``).  ``--chain N`` is the number of calls in one timed window and
``--reps R`` the number of windows (the median is reported).
``transformer`` times the block's train step by default (K6 forward, K7
backward on the ``flash`` path) and its forward with ``--fwd-only``;
``attention --grad`` times forward plus backward.

Run:
    python -m param_tpu_torch.cli.compute gemm --dataset A --dtype bfloat16 --pallas
    python -m param_tpu_torch.cli.compute gemm --dataset C --compare
    python -m param_tpu_torch.cli.compute gemm --weight-resident 8 --shape 128,4096,4096 --dtype bfloat16
    python -m param_tpu_torch.cli.compute emb --dataset baseline
    python -m param_tpu_torch.cli.compute linear --shape 18,1024,1024,1024,512
    python -m param_tpu_torch.cli.compute attention --dataset llama2 --paths xla,flash,dpa
    python -m param_tpu_torch.cli.compute attention --dataset llama2 --grad
    python -m param_tpu_torch.cli.compute transformer --dataset llama2
    python -m param_tpu_torch.cli.compute transformer --dataset llama2 --fwd-only
    python -m param_tpu_torch.cli.compute decode --dataset llama3-gqa
    python -m param_tpu_torch.cli.compute serve --dataset llama2 --dtype int4
"""

from __future__ import annotations

import argparse
import logging
import sys


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

    a = sub.add_parser("attention", help="fused-attention bench (flash "
                       "kernels K6 / K7 against unfused attention)")
    a.add_argument("--dataset", default="gpt2", choices=["gpt2", "llama2"])
    a.add_argument("--shape", default=None,
                   help="explicit batch,heads,seq,headdim (overrides "
                        "--dataset)")
    a.add_argument("--dtype", default="bfloat16")
    a.add_argument("--paths", default="xla,flash",
                   help="comma list of xla|flash|dpa")
    a.add_argument("--no-causal", action="store_true",
                   help="bidirectional attention (default causal)")
    a.add_argument("--block-q", type=int, default=1024)
    a.add_argument("--block-k", type=int, default=1024)
    a.add_argument("--grad", action="store_true",
                   help="forward + backward: the gradients of q, k and v "
                        "(flash: K6 then K7)")
    a.add_argument("--chain", type=int, default=16)
    a.add_argument("--reps", type=int, default=2)

    dec = sub.add_parser("decode", help="serving decode step: one query "
                         "token vs a (B,H,S,D) KV cache; GB/s of KV "
                         "traffic vs the memory rate")
    dec.add_argument("--dataset", default="llama2",
                     choices=["llama2", "gpt2", "llama3-gqa"])
    dec.add_argument("--shape", default=None,
                     help="explicit batch,heads,kvlen,headdim (or "
                          "batch,heads,kvheads,kvlen,headdim for GQA)")
    dec.add_argument("--dtype", default="bfloat16")
    dec.add_argument("--chain", type=int, default=16)
    dec.add_argument("--reps", type=int, default=2)

    srv = sub.add_parser("serve", help="whole-block decode step (cached "
                         "attention + MLP at T=1): serving tokens/s vs "
                         "the weight+KV streaming bound")
    srv.add_argument("--dataset", default="llama2",
                     choices=["llama2", "gpt2", "llama3-gqa"])
    srv.add_argument("--shape", default=None,
                     help="explicit batch,cachelen,emb,heads,ffn (or "
                          "batch,cachelen,emb,heads,kvheads,ffn for GQA)")
    srv.add_argument("--dtype", default="bfloat16",
                     help="bfloat16/float32, or weight-only quantized "
                          "serving: int8 (per-column scales) / int4 "
                          "(group-128, nibble-packed weights on K5)")
    srv.add_argument("--chain", type=int, default=16)
    srv.add_argument("--reps", type=int, default=2)

    t = sub.add_parser("transformer", help="pre-LN transformer-block train "
                       "step (flash attention K6 / K7 vs unfused; "
                       "GPT2/llama2 dims)")
    t.add_argument("--dataset", default="all",
                   choices=["gpt2", "gpt2-medium", "llama2", "all"])
    t.add_argument("--shape", default=None,
                   help="explicit batch,seq,emb,heads,ffn (overrides "
                        "--dataset)")
    t.add_argument("--dtype", default="bfloat16")
    t.add_argument("--paths", default="flash,xla",
                   help="comma list of flash|xla attention paths")
    t.add_argument("--no-causal", action="store_true")
    t.add_argument("--fwd-only", action="store_true",
                   help="forward only (default: the train step, forward + "
                        "backward + SGD)")
    t.add_argument("--chain", type=int, default=8)
    t.add_argument("--reps", type=int, default=2)

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


def _paths(ns):
    return [p.strip() for p in ns.paths.split(",") if p.strip()]


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    logging.basicConfig(level=ns.log.upper())

    from param_tpu_torch.ops import compute_bench as cb
    from param_tpu_torch.ops import datasets
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
                    r = cb.bench_gemm([(m, n, k)], dtype=ns.dtype,
                                   iters=ns.chain, reps=ns.reps,
                                   use_pallas=use_kernel,
                                   precision=ns.precision, device=dev)[0]
                    print(f"{m:>10} {n:>10} {k:>10} {label:>8} "
                          f"{r.lat_us:>12.1f} {r.tflops:>12.3f}")
            return 0
        if ns.cmd == "gemm":
            results = cb.bench_gemm(
                _shapes(ns, datasets.GEMM_DATASETS), dtype=ns.dtype,
                iters=ns.chain, reps=ns.reps, use_pallas=ns.pallas,
                precision=ns.precision, weight_resident=ns.weight_resident,
                device=dev)
        elif ns.cmd == "emb":
            results = cb.bench_emb(
                _shapes(ns, datasets.EMB_DATASETS), dtype=ns.dtype,
                iters=ns.chain, reps=ns.reps, distribution=ns.distribution,
                max_rows=ns.max_rows or None, device=dev)
        elif ns.cmd == "attention":
            results = cb.bench_attention(
                _shapes(ns, datasets.ATTN_DATASETS), dtype=ns.dtype,
                causal=not ns.no_causal, paths=_paths(ns), iters=ns.chain,
                reps=ns.reps, block_q=ns.block_q, block_k=ns.block_k,
                grad=ns.grad, device=dev)
        elif ns.cmd == "decode":
            results = cb.bench_decode_attention(
                _shapes(ns, datasets.DECODE_DATASETS), dtype=ns.dtype,
                iters=ns.chain, reps=ns.reps, device=dev)
        elif ns.cmd == "serve":
            results = cb.bench_block_decode(
                _shapes(ns, datasets.SERVE_DATASETS), dtype=ns.dtype,
                iters=ns.chain, reps=ns.reps, device=dev)
        elif ns.cmd == "transformer":
            results = cb.bench_transformer(
                _shapes(ns, datasets.TRANSFORMER_DATASETS), dtype=ns.dtype,
                causal=not ns.no_causal, paths=_paths(ns), iters=ns.chain,
                reps=ns.reps, grad=not ns.fwd_only, device=dev)
        else:
            results = cb.bench_mlp(
                _shapes(ns, datasets.MLP_DATASETS), dtype=ns.dtype,
                optimizer=ns.optimizer, fwd_only=ns.fwd_only, iters=ns.chain,
                reps=ns.reps, device=dev)
    cb.print_results(results, ns.dtype, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
