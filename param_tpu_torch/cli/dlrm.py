"""CLI for the DLRM trainer on one GPU (port of ``param_tpu/cli/dlrm.py``).

Same flags as the reference plus ``--device`` (default ``cuda``).
``--train-batches N`` trains for N batches on synthetic data and prints the
loss curve and the held-out AUC.  The per-region comm bench, ``--print-comms``
and ``--packed-tables`` are not ported (ROADMAP queue 1 item 7).

Run:
    python -m param_tpu_torch.cli.dlrm --train-batches 100 --optimizer sparse_adagrad
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 7: sharded DLRM, " \
              "dlrm_bench regions)"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="param_tpu_torch.dlrm",
        description="PARAM DLRM trainer, PyTorch/CUDA port")
    ap.add_argument("--num-tables", type=int, default=8)
    ap.add_argument("--rows", type=int, default=100_000, help="rows per table")
    ap.add_argument("--emb-dim", type=int, default=64)
    ap.add_argument("--nnz", type=int, default=10, help="lookups per sample per table")
    ap.add_argument("--dense-dim", type=int, default=64)
    ap.add_argument("--arch-mlp-bot", default="512-256-64")
    ap.add_argument("--arch-mlp-top", default="512-256-1")
    ap.add_argument("--mini-batch-size", "--batch", type=int, default=2048)
    ap.add_argument("--optimizer", default="adagrad",
                    choices=["sgd", "adagrad", "sparse_sgd", "sparse_adagrad"],
                    help="sparse_* update only the gathered table rows")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--packed-tables", action="store_true",
                    help="TPU lane-packed storage; rejected by the port")
    # accepted for flag parity with the reference; only its per-region
    # bench (not ported) reads them
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--regions", default=None)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--max-chain", type=int, default=1024)
    ap.add_argument("--print-comms", default=None, metavar="PATH")
    ap.add_argument("--train-batches", type=int, default=0,
                    help="run an end-to-end training loop for N batches on "
                         "synthetic data and report loss curve + held-out AUC")
    ap.add_argument("--data", default="synthetic", choices=["synthetic", "random"])
    ap.add_argument("--data-distribution", default="uniform",
                    choices=["uniform", "zipf"])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the training steps after the first with "
                         "torch.profiler into DIR and print the top "
                         "operators by device time")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain versions)")
    ap.add_argument("--log", default="INFO")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    ns = ap.parse_args(argv)
    logging.basicConfig(level=ns.log.upper())
    if ns.packed_tables:
        ap.error("--packed-tables is a TPU lane layout; the port stores "
                 "tables as (T, E, D)")
    if ns.print_comms:
        raise NotImplementedError(f"--print-comms {_NOT_PORTED}")
    if not ns.train_batches:
        raise NotImplementedError(f"the per-region DLRM bench {_NOT_PORTED}; "
                                  f"use --train-batches N")

    from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel

    cfg = DlrmConfig(
        num_tables=ns.num_tables,
        rows_per_table=ns.rows,
        emb_dim=ns.emb_dim,
        nnz=ns.nnz,
        dense_dim=ns.dense_dim,
        bot_mlp=[int(x) for x in ns.arch_mlp_bot.split("-")],
        top_mlp=[int(x) for x in ns.arch_mlp_top.split("-")],
        batch=ns.mini_batch_size,
    )
    model = DlrmModel(cfg, device=ns.device)
    return train_e2e(model, cfg, ns)


def train_e2e(model, cfg, ns) -> int:
    """End-to-end training with a loss curve and held-out AUC."""
    import numpy as np
    import torch

    from param_tpu_torch.models.dlrm_data import data_loader
    from param_tpu_torch.ops.mlp import make_optimizer
    from param_tpu_torch.utils.profiler import make_profiler
    from param_tpu_torch.utils.timer import sync

    ds = data_loader(
        ns.data,
        batch=cfg.batch, dense_dim=cfg.dense_dim, num_tables=cfg.num_tables,
        nnz=cfg.nnz, num_rows=cfg.rows_per_table,
        num_batches=ns.train_batches + 1, distribution=ns.data_distribution,
    )
    batches = list(ds)
    params = model.init_params(0)
    if ns.optimizer == "sparse_sgd":
        sparse_step = model.make_sparse_sgd_step(ns.lr)
        st = None
    elif ns.optimizer == "sparse_adagrad":
        sparse_step = model.make_sparse_adagrad_step(ns.lr)
        st = model.init_adagrad_state(params)
    else:
        opt = make_optimizer(ns.optimizer, ns.lr)
        step = model.make_train_step(opt)
        st = opt.init(params)
    dev = model.device
    prof = make_profiler(dev) if ns.profile else None
    sync(dev)
    t0 = time.perf_counter()
    t_first = None
    for i, batch in enumerate(batches[:-1]):
        b = model.place_batch(batch)
        if ns.optimizer == "sparse_sgd":
            params, loss = sparse_step(params, *b)
        elif ns.optimizer == "sparse_adagrad":
            params, st, loss = sparse_step(params, st, *b)
        else:
            params, st, loss = step(params, st, *b)
        if i % max(1, ns.train_batches // 10) == 0:
            print(f"batch {i:5d}  loss {float(loss):.5f}")
        if i == 0:
            sync(dev)
            t_first = time.perf_counter()
            if prof is not None:
                prof.start()
    sync(dev)
    t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
        report_profile(prof, ns.profile, (t1 - t_first) * 1e6,
                       ns.train_batches - 1, dev.type == "cuda")
    dt = t1 - t0
    # mean over the steps after the first, which pays one-off set-up
    steady_ms = ((t1 - t_first) * 1e3 / (ns.train_batches - 1)
                 if ns.train_batches > 1 else dt * 1e3)

    labels = batches[-1][2]
    with torch.no_grad():
        logits = model.forward(params, *model.place_batch(batches[-1])[:2])
    logits = logits.float().cpu().numpy()
    order = np.argsort(logits)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(logits))
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    auc = (
        (ranks[pos].sum() - n_pos * (n_pos - 1) / 2) / (n_pos * n_neg)
        if n_pos and n_neg else 0.5
    )
    qps = ns.train_batches * cfg.batch / dt
    print(f"DLRM-E2E batches={ns.train_batches} wall={dt:.1f}s "
          f"QPS={qps:.0f} held-out AUC={auc:.4f} device={dev.type} "
          f"step_ms={steady_ms:.3f}")
    return 0


def report_profile(prof, out_dir: str, window_us: float, n_steps: int,
                   on_cuda: bool) -> None:
    """Write the trace of the steps after the first to ``out_dir``; print
    the top operators by device time and the kernel time per step.  The
    profiler slows the host, so the window's wall time is not a step time:
    compare the device time per step with ``step_ms`` of a run without
    ``--profile``."""
    from param_tpu_torch.utils.profiler import write_trace

    totals = write_trace(prof, out_dir, on_cuda)
    if totals is None:
        return
    kernel_us, launches = totals
    print(f"profile: {n_steps} steps, kernel time {kernel_us / 1e3 / n_steps:.3f}"
          f" ms/step over {launches / n_steps:.0f} device ops/step; wall "
          f"under the profiler {window_us / 1e3 / n_steps:.3f} ms/step")


if __name__ == "__main__":
    sys.exit(main())
