"""Execution-trace CLI: capture a built-in workload, validate, replay op by
op, or generate a standalone replay script (the port's
``param_tpu.cli.et``; PARAM's ``et_replay/tools/et_replay.py`` main).

    python -m param_tpu_torch.cli.et capture --workload dlrm -o dlrm_et.json.gz
    python -m param_tpu_torch.cli.et validate dlrm_et.json.gz
    python -m param_tpu_torch.cli.et replay dlrm_et.json.gz --iters 3
    python -m param_tpu_torch.cli.et codegen dlrm_et.json.gz -o replay_dlrm.py

Every command runs on the card unless ``--device cpu`` is given (before or
after the command).  ``validate`` also reads the JAX package's jaxpr traces;
``replay`` and ``codegen`` take the port's own.  A trace with collectives
replays them on the default process group (torchrun's world, or a world of
one: NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=argparse.SUPPRESS,
                        help="cuda (default) or cpu")
    common.add_argument("--log", default=argparse.SUPPRESS)
    ap = argparse.ArgumentParser(prog="param_tpu_torch.et", parents=[common],
                                 description="PARAM execution-trace tool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("capture", parents=[common],
                       help="capture a built-in workload's ET")
    c.add_argument("--workload", default="dlrm",
                   choices=["dlrm", "mlp", "dlrm_train"])
    c.add_argument("-o", "--output", required=True)
    c.add_argument("--iterations", type=int, default=1)

    v = sub.add_parser("validate", parents=[common], help="validate an ET file")
    v.add_argument("path")

    r = sub.add_parser("replay", parents=[common], help="replay an ET op by op")
    r.add_argument("path")
    r.add_argument("--mode", default="full", choices=["full", "comp", "comm"])
    r.add_argument("--alloc", default="pre", choices=["pre", "lazy"])
    r.add_argument("--iters", type=int, default=1)
    r.add_argument("--warmup", type=int, default=1)
    r.add_argument("--config", default=None, help="skip-node replay config JSON")
    r.add_argument("--inputs", default=None,
                   help=".npz with tensor-id -> array input overrides")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the replay into DIR "
                        "(the reference's kineto-profiled replay, "
                        "et_replay.py:1528-1620)")
    r.add_argument("--per-op", action="store_true",
                   help="record blocking per-op latencies on the last "
                        "iteration")
    r.add_argument("--update-config", default=None,
                   help="write the auto-updated skip config here")

    g = sub.add_parser("codegen", parents=[common],
                       help="generate a standalone replay script "
                            "(reference -g mode)")
    g.add_argument("path")
    g.add_argument("-o", "--output", required=True)
    return ap


def workload(name: str, device):
    """``(fn, args)`` of a built-in workload at the JAX CLI's sizes: the
    DLRM forward or its SGD(0.01) train step (4 tables x 1000 x 16, nnz 4,
    dense 16, MLPs 32-16 / 32-1, batch 64), or an MLP 64-128-64 on (32, 64)
    ones.  Parameters come from seed 0."""
    import torch

    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
    from param_tpu_torch.models.dlrm_data import RandomDataset
    from param_tpu_torch.ops.mlp import Sgd, init_mlp, mlp_forward

    if name in ("dlrm", "dlrm_train"):
        cfg = DlrmConfig(num_tables=4, rows_per_table=1000, emb_dim=16, nnz=4,
                         dense_dim=16, bot_mlp=[32, 16], top_mlp=[32, 1],
                         batch=64)
        model = DlrmModel(cfg, device=device)
        params = model.init_params(0)
        ds = RandomDataset(batch=64, dense_dim=16, num_tables=4, nnz=4,
                           num_rows=1000, num_batches=1)
        dense, idx, labels = model.place_batch(next(iter(ds)))
        if name == "dlrm":
            def forward(p, d, i):
                with torch.no_grad():
                    return model.forward(p, d, i)

            return forward, (params, dense, idx)
        opt = Sgd(0.01)
        return model.make_train_step(opt), (params, opt.init(params), dense,
                                            idx, labels)
    if name == "mlp":
        gen = torch.Generator(device=device).manual_seed(0)
        p = init_mlp(gen, [64, 128, 64], device=device)
        return mlp_forward, (p, torch.ones((32, 64), device=device))
    raise ValueError(name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ns = build_parser().parse_args(argv)
    device = getattr(ns, "device", "cuda")
    logging.basicConfig(level=getattr(ns, "log", "INFO").upper())
    from param_tpu_torch.trace.execution_trace import (
        ExecutionTrace, TraceValidator,
    )

    if ns.cmd == "capture":
        from param_tpu_torch.trace.capture import capture_execution_trace
        from param_tpu_torch.utils.device import resolve_device

        fn, args = workload(ns.workload, resolve_device(device))
        et = capture_execution_trace(fn, *args, iterations=ns.iterations)
        et.save(ns.output)
        print(f"captured {len(et.get_nodes(clean=True))} ops "
              f"({len(et.tensors)} tensors, {et.iterations()} iterations) "
              f"-> {ns.output}")
        return 0
    if ns.cmd == "validate":
        et = ExecutionTrace.load(ns.path)
        v = TraceValidator(et)
        errors = v.validate()
        print(f"schema={et.schema} ops={v.num_ops()} "
              f"comm_ops={v.num_comm_ops()} errors={len(errors)}")
        for e in errors[:20]:
            print(" ", e)
        return 1 if errors else 0
    from param_tpu_torch.trace import et_replay

    et = ExecutionTrace.load(ns.path)
    if ns.cmd == "codegen":
        code = et_replay.generate_code(et)
        with open(ns.output, "w") as f:
            f.write(code)
        print(f"wrote replay script ({len(code.splitlines())} lines) -> "
              f"{ns.output}")
        return 0
    # replay
    from param_tpu_torch.utils.profiler import profile_to

    mode = et_replay.ReplayMode(ns.mode)
    backend = None
    if et.comm_nodes() and mode != et_replay.ReplayMode.COMPUTE:
        from param_tpu_torch.backend import DistBackend

        backend = DistBackend(device)
        backend.initialize()
        device = backend.device
    try:
        mgr = et_replay.EtReplayManager(
            et, mode=mode, alloc=et_replay.AllocationMode(ns.alloc),
            config=(et_replay.ReplayConfig.load(ns.config) if ns.config
                    else None),
            inputs_file=ns.inputs, device=device)
        with profile_to(ns.profile, mgr.device):
            out = mgr.replay(iters=ns.iters, warmup=ns.warmup,
                             per_op=ns.per_op)
    finally:
        if backend is not None:
            backend.shutdown()
    print(json.dumps(out, indent=2))
    if ns.update_config:
        mgr.config.save(ns.update_config)
        print(f"wrote skip config -> {ns.update_config}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
