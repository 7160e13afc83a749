"""CvT convolution-layer benchmark CLI (port of ``param_tpu/cli/cvt.py``).

Reference main: ``train/compute/pt/pytorch_cvt_convs.py:217-410``
(``--warmups``, ``--steps``, ``--device``, ``--forward_only`` over the 11
CvT-paper layer configs).  ``--steps`` calls make one window timed by CUDA
events (at most ``--max-chain``, the JAX package's cap on timed calls), the
median of ``--reps`` windows is reported; ``--device`` defaults to
``cuda``.

    python -m param_tpu_torch.cli.cvt --forward-only --dtype bf16
    python -m param_tpu_torch.cli.cvt --layer stage0 --forward-only --device cpu
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="param_tpu_torch.cvt")
    ap.add_argument("--steps", type=int, default=8,
                    help="calls in a timed window (reference --steps)")
    ap.add_argument("--max-chain", type=int, default=64,
                    help="cap on the calls in a timed window")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed windows (median reported)")
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "bf16"])
    ap.add_argument("--layer", default=None,
                    help="substring filter over layer names "
                         "(e.g. stage0, patch_embed)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the host)")
    ap.add_argument("--log", default="INFO")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    import logging

    logging.basicConfig(level=ns.log.upper())
    import torch

    from param_tpu_torch.ops.cvt_convs import CVT_CONFIGS, bench_cvt, report

    configs = CVT_CONFIGS
    if ns.layer:
        configs = [c for c in configs if ns.layer in c.name]
        if not configs:
            print(f"no layer matches {ns.layer!r}", file=sys.stderr)
            return 1
    dtype = torch.bfloat16 if ns.dtype in ("bf16", "bfloat16") else torch.float32
    # one config at a time so results stream as they are measured
    for cfg in configs:
        report(bench_cvt([cfg], forward_only=ns.forward_only, dtype=dtype,
                         steps=ns.steps, max_calls=ns.max_chain,
                         reps=ns.reps, device=ns.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
