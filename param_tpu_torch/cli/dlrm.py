"""CLI for the DLRM communication-pattern benchmark and trainer (port of
``param_tpu/cli/dlrm.py``).

Same flags as the reference plus ``--device`` (default ``cuda``).  With no
``--train-batches`` it runs the per-region bench (``models.dlrm_bench``)
over the world, table-wise sharded, and prints the reference's 21-row
``DLRM-RES`` table and ``QPS:``; ``--print-comms PATH`` writes the step's
comm pattern as JSON and exits.  The world is ``torchrun``'s, or a world of
one (NCCL on the card, gloo with ``--device cpu``).  ``--train-batches N``
trains for N batches on synthetic data and prints the loss curve and the
held-out AUC: under ``torchrun`` with a world above one, the sharded model
(rank 0 prints); run alone, the single-device trainer.  ``--packed-tables``
is a TPU layout and is refused.

Run:
    python -m param_tpu_torch.cli.dlrm
    python -m param_tpu_torch.cli.dlrm --train-batches 100 --optimizer sparse_adagrad
    torchrun --standalone --nproc-per-node 4 -m param_tpu_torch.cli.dlrm -- \
        --train-batches 100
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


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
    ap.add_argument("--reps", type=int, default=3,
                    help="timed windows per region")
    ap.add_argument("--regions", default=None,
                    help="comma-separated subset of timer regions to run "
                         "(default: all)")
    ap.add_argument("--chain", type=int, default=8,
                    help="calls per timing window")
    ap.add_argument("--max-chain", type=int, default=1024,
                    help="cap on a window's growth (a window under 1 ms "
                         "doubles)")
    ap.add_argument("--print-comms", default=None, metavar="PATH",
                    help="dump the per-step comm pattern as a basic-schema "
                         "JSON trace to PATH and exit")
    ap.add_argument("--train-batches", type=int, default=0,
                    help="run an end-to-end training loop for N batches on "
                         "synthetic data and report loss curve + held-out AUC")
    ap.add_argument("--data", default="synthetic", choices=["synthetic", "random"])
    ap.add_argument("--data-distribution", default="uniform",
                    choices=["uniform", "zipf"])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the bench, or the training steps after the "
                         "first, with torch.profiler into DIR and print the "
                         "top operators by device time (rank 0)")
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
    if ns.train_batches and not ns.print_comms and \
            int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return train_e2e(DlrmModel(cfg, device=ns.device), cfg, ns)

    from param_tpu_torch.backend import DistBackend

    backend = DistBackend(ns.device)
    backend.initialize()
    try:
        model = DlrmModel(cfg, group=backend.get_default_group(),
                          device=backend.device)
        if ns.print_comms or not ns.train_batches:
            return run_bench(model, ns)
        return train_e2e(model, cfg, ns)
    finally:
        backend.shutdown()


def run_bench(model, ns) -> int:
    """The per-region bench (or ``--print-comms``) on this rank."""
    from param_tpu_torch.models.dlrm_bench import DlrmCommBench
    from param_tpu_torch.ops.mlp import make_optimizer
    from param_tpu_torch.utils.profiler import profile_to

    opt = (ns.optimizer if ns.optimizer.startswith("sparse")
           else make_optimizer(ns.optimizer, ns.lr))
    bench = DlrmCommBench(model, opt, lr=ns.lr)
    lead = model.rank == 0
    if ns.print_comms:
        if lead:
            bench.dump_comms(ns.print_comms)
            print(f"wrote comm pattern to {ns.print_comms}")
        return 0
    regions = ns.regions.split(",") if ns.regions else None
    with profile_to(ns.profile if lead else None, model.device):
        results = bench.run(reps=ns.reps, chain=ns.chain, regions=regions,
                            max_chain=ns.max_chain)
    if lead:
        if ns.profile:
            report_spans(ns.profile, model.device.type == "cuda")
        bench.report(results)
    return 0


def train_e2e(model, cfg, ns) -> int:
    """End-to-end training with a loss curve and held-out AUC.  Every rank
    of a sharded model reads the same global batches and keeps its rows;
    rank 0 prints the global loss, and the AUC of every rank's logits."""
    import numpy as np
    import torch

    from param_tpu_torch.models.dlrm_data import data_loader
    from param_tpu_torch.ops.mlp import make_optimizer
    from param_tpu_torch.utils.profiler import make_profiler, reset
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
    lead = model.rank == 0
    prof = make_profiler(dev) if ns.profile and lead else None
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
        if i % max(1, ns.train_batches // 10) == 0 and lead:
            print(f"batch {i:5d}  loss {float(loss):.5f}")
        if i == 0:
            sync(dev)
            t_first = time.perf_counter()
            if prof is not None:
                prof.start()
                reset()
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
        logits = model.gather_rows(logits)
    if not lead:
        return 0
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
    world = f" world={model.n}" if model.group is not None else ""
    print(f"DLRM-E2E batches={ns.train_batches} wall={dt:.1f}s "
          f"QPS={qps:.0f} held-out AUC={auc:.4f} device={dev.type} "
          f"step_ms={steady_ms:.3f}{world}")
    return 0


def report_profile(prof, out_dir: str, window_us: float, n_steps: int,
                   on_cuda: bool) -> None:
    """Write the trace of the steps after the first to ``out_dir``; print
    the top operators by device time, the spans (:func:`report_spans`) and
    the device's busy time per step (the union of its operations, so
    kernels that overlap count once).  The profiler slows the host, so the
    window's wall time is not a step time: compare the device time per step
    with ``step_ms`` of a run without ``--profile``."""
    from param_tpu_torch.utils.profiler import write_trace

    write_trace(prof, out_dir, on_cuda)
    trace = report_spans(out_dir, on_cuda)
    if not on_cuda:
        return
    busy_ms = trace["busy_us"] / 1e3 / n_steps
    print(f"profile: {n_steps} steps, device busy {busy_ms:.3f} ms/step over "
          f"{trace['device_ops'] / n_steps:.0f} device ops/step; wall under "
          f"the profiler {window_us / 1e3 / n_steps:.3f} ms/step")


def report_spans(out_dir: str, on_cuda: bool) -> dict:
    """Print the spans and counters that the steps recorded while the
    profiler ran (``utils.profiler``), a step being a ``dlrm.step`` span,
    and, on the card, the busy and idle time inside each span and the
    longest idle gaps from ``out_dir/trace.json``
    (``trace.device_trace.span_idle``); write the totals to
    ``out_dir/spans.json``.  Returns ``span_idle``'s figures."""
    import json

    from param_tpu_torch.trace.device_trace import load_chrome_trace, span_idle
    from param_tpu_torch.utils.profiler import counter_totals, span_totals

    spans, counters = span_totals(), counter_totals()
    steps = spans.get("dlrm.step", {}).get("count", 0)
    per = max(steps, 1)
    row = "{:<20}{:>8}{:>10}{:>10}{:>10}".format
    clock = "device" if on_cuda else "host clock, CPU run"
    print(f"spans over {steps} steps, a step ({clock} ms):")
    print(row("span", "count", "ms", "self ms", "host ms"))
    for name, t in spans.items():
        print(row(name, *(f"{t[k] / per:.3f}" for k in (
            "count", "device_ms", "self_device_ms", "host_ms"))))
    for name, v in counters.items():
        print(f"counter {name}: {v / per:.1f} a step")
    if counters.get("dlrm.lookups") and "dlrm.unique_rows" in counters:
        share = counters["dlrm.unique_rows"] / counters["dlrm.lookups"]
        print(f"unique rows: {100.0 * share:.2f}% of lookups")
    trace = span_idle(load_chrome_trace(os.path.join(out_dir,
                                                     "trace.json"))[0])
    if on_cuda:
        print(row("device in span", "extents", "busy ms", "idle ms", ""))
        for name, d in trace["spans"].items():
            print(row(name, f"{d['count'] / per:.3f}",
                      f"{d['busy_us'] / 1e3 / per:.3f}",
                      f"{d['idle_us'] / 1e3 / per:.3f}", ""))
        for g in trace["gaps"]:
            print(f"idle {g['us']:.1f} us in {g['span']} before {g['before']}")
    with open(os.path.join(out_dir, "spans.json"), "w") as f:
        json.dump({"steps": steps, "spans": spans, "counters": counters}, f,
                  indent=1)
    return trace


if __name__ == "__main__":
    sys.exit(main())
