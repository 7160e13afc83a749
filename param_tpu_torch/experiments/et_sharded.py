"""The execution-trace round trip of the table-wise sharded DLRM dense step
(the port's dry-run path 4, ``__graft_entry__.py:142-168``), one process a
rank (torchrun; one card each on NCCL, or gloo with ``--device cpu``; a
world of one without torchrun).  Rank 0 prints one JSON line; a failed
check on any rank exits 1.

Each rank captures ``make_train_step(Sgd(LR))`` on its shard of the
model at the trainer's default width (``--small``: 4 x 512 x 16, batch 64),
replays the trace on the live world with its real inputs (``ITERS`` after
one warm-up), and holds every output (the updated parameters, the loss) to
the direct step's from the same inputs within rtol 1e-5, atol 1e-6; the
replay must report no error and no skipped node, leave the given inputs
alone, and launch K1 once an iteration on the card.

    torchrun --standalone --nproc-per-node 4 \\
        -m param_tpu_torch.experiments.et_sharded
    torchrun --standalone --nproc-per-node 2 \\
        -m param_tpu_torch.experiments.et_sharded -- --device cpu --small
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch
import torch.distributed as dist

from param_tpu_torch import kernels
from param_tpu_torch.backend import CollectiveArgs, DistBackend
from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel
from param_tpu_torch.models.dlrm_data import RandomDataset
from param_tpu_torch.ops.mlp import Sgd, tree_map
from param_tpu_torch.trace.capture import (
    capture_execution_trace, inputs_for, tensor_leaves,
)
from param_tpu_torch.trace.comms_trace import comms_from_et
from param_tpu_torch.trace.et_replay import EtReplayManager

LR = 0.01
ITERS = 3
SMALL = dict(num_tables=4, rows_per_table=512, emb_dim=16, nnz=4,
             dense_dim=16, bot_mlp=[32, 16], top_mlp=[32, 1], batch=64)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check(backend, cfg: DlrmConfig, params=None, batch=None):
    """Capture, replay and compare on this rank: ``params`` is this rank's
    shard (``init_params(0)`` when None), ``batch`` the global host batch
    (a seeded ``RandomDataset`` batch when None).  Returns ``(record, et,
    replayed, direct)``, the last two the replay's and the direct step's
    output leaves."""
    dev = backend.get_device()
    model = DlrmModel(cfg, group=backend.get_default_group(), device=dev)
    if params is None:
        params = model.init_params(0)
    if batch is None:
        batch = next(iter(RandomDataset(
            batch=cfg.batch, dense_dim=cfg.dense_dim,
            num_tables=cfg.num_tables, nnz=cfg.nnz,
            num_rows=cfg.rows_per_table, num_batches=1, seed=23)))
    batch = model.place_batch(batch)
    step = model.make_train_step(Sgd(LR))

    def args():
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        return (p, None, *batch)

    want = [t.detach() for t in tensor_leaves(step(*args()))]
    host_ms = []
    a = args()
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        step(*a)
        _sync(dev)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    del a
    et = capture_execution_trace(step, *args())
    given = args()
    mgr = EtReplayManager(et, inputs=inputs_for(et, *given), device=dev)
    kernels.reset_launch_counts()
    report = mgr.replay(iters=ITERS, warmup=1)
    unchanged = all(torch.equal(a, b) for a, b in zip(
        tensor_leaves(given), tensor_leaves(args())))
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    got = mgr.outputs()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    close = len(got) == len(want) and all(
        torch.allclose(g, w, rtol=1e-5, atol=1e-6) for g, w in zip(got, want))
    k1 = launches.get("emb_gather", 0)
    ok = (close and unchanged and report["errors"] == {}
          and report["num_skipped"] == 0
          and (dev.type != "cuda" or k1 == ITERS + 1))
    rec = dict(ok=ok, rank=backend.get_global_rank(),
               world=backend.get_world_size(), num_ops=report["num_ops"],
               comm_ops=len(comms_from_et(et, backend.get_world_size())),
               errors=report["errors"], num_skipped=report["num_skipped"],
               inputs_unchanged=unchanged,
               max_abs_err=max(errs) if errs else None, outputs=len(got),
               launches=launches, iter_s=report["iter_s"], qps=report["qps"],
               direct_host_ms=statistics.median(host_ms))
    return rec, et, got, want


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:  # what torchrun passes on after ``-m ... --``
        argv = argv[1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="small sizes (a CPU rehearsal)")
    ns = ap.parse_args(argv)
    backend = DistBackend(ns.device)
    backend.initialize()
    try:
        cfg = DlrmConfig(**SMALL) if ns.small else DlrmConfig()
        rec = check(backend, cfg)[0]
        flag = torch.tensor([float(rec["ok"])], device=backend.get_device())
        agreed = backend.all_reduce(CollectiveArgs(in_tensor=flag,
                                                   red_op="min"))
        per_rank = [None] * backend.get_world_size()
        dist.all_gather_object(per_rank, rec)
        ok = bool(agreed.item() > 0.5)
        if backend.get_global_rank() == 0:
            print(json.dumps({"ok": ok, "ranks": per_rank}), flush=True)
    finally:
        backend.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
