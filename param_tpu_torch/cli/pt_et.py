"""CLI for the ATen-op-level compute replay of PyTorch execution traces
(the port's ``param_tpu.cli.pt_et``; PARAM's ``et_replay/tools/
et_replay.py`` main: ``--input``, ``-c`` compute mode).  The comm stream
of the same traces replays through ``python -m param_tpu_torch.cli.replay
--trace-type pytorch_et``.

    python -m param_tpu_torch.cli.pt_et --trace linear_et.json.gz
    python -m param_tpu_torch.cli.pt_et \\
        --trace tests/fixtures/transformer_train_long_et.json.gz \\
        --fuse attention-train --cast bf16 --chain
    python -m param_tpu_torch.cli.pt_et --trace et.json.gz --codegen out.py

It runs on the card unless ``--device cpu`` is given.  ``--fuse
attention`` replays each attention window as one flash-attention call (K6
on the card), ``attention-train`` the backward windows too (K7).
``--chain`` times one iteration of the stream captured in a CUDA graph.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import sys
import tarfile


def load_trace(path: str) -> dict:
    """Load a PyTorch ET JSON, plain, .gz or .tar.gz."""
    if path.endswith(".tar.gz") or path.endswith(".tgz"):
        with tarfile.open(path) as t:
            for m in t.getmembers():
                if m.name.endswith(".json"):
                    return json.load(t.extractfile(m))
        raise ValueError(f"no .json member in {path}")
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="param_tpu_torch.pt_et",
        description="ATen-op-level compute replay of PyTorch ETs",
    )
    ap.add_argument("--trace", required=True, help="ET json(.gz/.tar.gz)")
    ap.add_argument("--mode", default="comp", choices=["comp", "full"],
                    help="comp = the ATen stream only; full = also the "
                         "record_param_comms nodes through the backend at "
                         "their recorded positions (PARAM's ReplayMode)")
    ap.add_argument("--target-rank", type=int, default=0)
    ap.add_argument("--backend", default="dist",
                    choices=["dist", "torchcomms", "mock"],
                    help="the comm backend of --mode full")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--max-ops", type=int, default=None,
                    help="replay only the first N selected ops")
    ap.add_argument("--max-tensor-bytes", type=int, default=None,
                    help="shrink fbgemm embedding weight blobs above this "
                         "size to row surrogates, so that multi-GB lookup "
                         "ops fit (the report lists them)")
    ap.add_argument("--chain", action="store_true",
                    help="capture one iteration of the op stream in a CUDA "
                         "graph and time its replays by CUDA events")
    ap.add_argument("--cast", default=None, choices=[None, "bf16"],
                    help="what-if precision: materialize the recorded f32 "
                         "tensors as bfloat16")
    ap.add_argument("--fuse", default=None,
                    choices=[None, "attention", "attention-train"],
                    help="what-if kernel fusion: match the attention "
                         "windows (matmul / div / where / softmax / matmul) "
                         "of the op stream and replay each as one flash-"
                         "attention call (K6); 'attention-train' also "
                         "replaces the backward windows with "
                         "flash_attention_bwd (K7)")
    ap.add_argument("--skip-config", default=None,
                    help="JSON skip config; updated with the ops skipped")
    ap.add_argument("--codegen", default=None, metavar="OUT.py",
                    help="write a standalone PyTorch script of the op "
                         "stream instead of replaying (PARAM: et_replay "
                         "--dump benchmark_<rank>.py)")
    ap.add_argument("--output-json", default=None)
    ap.add_argument("--top", type=int, default=20,
                    help="rows in the per-op table")
    ap.add_argument("--log", default="WARNING")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    logging.basicConfig(level=ns.log.upper())
    data = load_trace(ns.trace)
    skip = set()
    if ns.skip_config and os.path.exists(ns.skip_config):
        with open(ns.skip_config) as f:
            skip = set(json.load(f).get("skip nodes", {}))
    backend = None
    if ns.mode == "full":
        from param_tpu_torch.backend import get_backend_cls

        cls = get_backend_cls(ns.backend)
        backend = cls() if ns.backend == "mock" else cls(ns.device)
        backend.initialize()
    try:
        return _run(ns, data, skip, backend)
    finally:
        if backend is not None:
            backend.shutdown()


def _run(ns, data, skip, backend) -> int:
    from param_tpu_torch.trace.pytorch_op_replay import PyTorchOpReplay

    replayer = PyTorchOpReplay(
        data, max_ops=ns.max_ops, skip_names=skip,
        skip_config_path=ns.skip_config, mode=ns.mode, backend=backend,
        target_rank=ns.target_rank, cast=ns.cast, fuse=ns.fuse,
        max_tensor_bytes=ns.max_tensor_bytes, device=ns.device,
    )
    print(f"selected {len(replayer.nodes)} ATen ops "
          f"(schema {replayer.et.schema})")
    if ns.fuse:
        ws = replayer.fused_windows
        n_ops = sum(len(w.skip_ids) for w in ws)
        shapes = sorted({w.shape for w in ws})
        print(f"fused {len(ws)} attention windows ({n_ops} ops) "
              f"shapes={shapes}")
        bws = replayer.fused_bwd_windows
        if bws:
            n_bops = sum(len(w.skip_ids) for w in bws)
            print(f"fused {len(bws)} attention BACKWARD windows "
                  f"({n_bops} ops) shapes={sorted({w.shape for w in bws})}")
        n_assumed = sum(w.mask_assumed for w in (*ws, *bws))
        if n_assumed:
            print(f"note: {n_assumed} window(s) replay as CAUSAL on the "
                  "strength of a recorded aten::where whose mask values "
                  "the trace does not carry; a padding/arbitrary mask "
                  "would have different semantics (and ~2x the flops)")

    if ns.codegen:
        src = replayer.codegen(ns.trace)
        with open(ns.codegen, "w") as f:
            f.write(src)
        print(f"wrote {len(src.splitlines())} lines -> {ns.codegen}")
        return 0

    if ns.chain:
        per_iter_ms = replayer.measure_chain_iteration()
        report = replayer.report(executed=0, wall_s=0.0, iters=0)
        report["chain_iteration_s"] = per_iter_ms / 1e3
        print(f"fused-iteration time: {per_iter_ms:.3f} ms "
              f"({1e3 / per_iter_ms:.1f} iters/s)")
    else:
        report = replayer.replay(iters=ns.iters)
        print(f"executed {report['num_executed']} ops in "
              f"{report['wall_s']:.2f} s")
        hdr = f"{'op':44s}{'count':>7s}{'p50(us)':>12s}{'total(us)':>14s}"
        print(hdr)
        for name, s in list(report["per_op"].items())[: ns.top]:
            print(f"{name:44s}{s['count']:7d}{s['p50_us']:12.1f}"
                  f"{s['total_us']:14.1f}")
    if report["skipped"]:
        print("skipped ops:")
        for name, why in report["skipped"].items():
            print(f"  {name}: {why}")
    if ns.output_json:
        with open(ns.output_json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
