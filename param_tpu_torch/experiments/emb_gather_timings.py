"""K1, the sum-pooled embedding bag, at every shape its paths launch, for
comparing two checkouts in one call.

For each shape (the comms-compute bench's and replay's lookup, the
microbench's per-table lookup, the trainer's in f32 and bf16, the bench
headline, the coalesced-fetch experiment's stage B with uniform and zipf
ids, ``configs/basic_ops.json``'s table) this prints one JSON line: K1's
ms a call from CUDA-graph replays (median and spread of 5 windows, 8
shifted id sets cycled), ``F.embedding_bag`` timed the same way, the byte
bound (the call's distinct rows, its ids and its output over 3.35 TB/s,
as ``chip_smoke.py``'s ``k1_case`` counts them), the largest error against
the plain bag, whether two launches on the same ids give equal bytes, the
schedule the launch took (where the checkout has ``emb_gather_schedule``)
and the card's name and power limit.  ``--sweep`` also times each shape
under other warps a bag and rows in flight (``forced_schedule``).

    python -m param_tpu_torch.experiments.emb_gather_timings [--sweep]
    python -m param_tpu_torch.experiments.emb_gather_timings \\
        --parent _checkout/parent [--sweep]

It calls only the wrapper ``emb_gather_cuda``, the plain bag and, where the
checkout has them, ``launch_schedule`` and ``forced_schedule``, so another
checkout's package is timed by the same script: with ``--parent DIR`` it
runs itself in turns in DIR and in this checkout (parent, this, this,
parent; one process each, on one card; ``--sweep`` then runs in a fifth
process) and ends with a line per shape beside the two trees' times.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from param_tpu_torch.kernels import bindings, build
from param_tpu_torch.kernels import emb_gather as k1
from param_tpu_torch.kernels.emb_gather import emb_gather_cuda, emb_gather_plain
from param_tpu_torch.utils.chip import bound_ms, nvidia_smi_name_power
from param_tpu_torch.utils.timer import time_samples

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SHIFTS = 8
# (name, table rows, dim, dtype, bags, nnz, ids, graph-replay calls a
# window): "uniform" draws each id from the table; "tables" the trainer's
# (8 tables of rows / 8, each bag's ids from one table); "zipf" stage B's
CASES = [
    ("comms_compute_f32", 100_000, 128, torch.float32, 2048, 30, "uniform",
     100),
    ("microbench_table_f32", 100_000, 64, torch.float32, 2048, 10, "uniform",
     100),
    ("dlrm_f32", 800_000, 64, torch.float32, 16384, 10, "tables", 100),
    ("dlrm_bf16", 800_000, 64, torch.bfloat16, 16384, 10, "tables", 100),
    ("headline_f32", 1_000_000, 128, torch.float32, 8192, 30, "uniform", 50),
    ("stage_b_uniform", 1_048_576, 128, torch.float32, 8192, 32, "uniform",
     50),
    ("stage_b_zipf", 1_048_576, 128, torch.float32, 8192, 32, "zipf", 50),
    ("microbench_basic_ops_f32", 1000, 16, torch.float32, 32, 8, "uniform",
     100),
]
# (warps a bag, rows in flight) timed by --sweep (forced_schedule): the
# design's steps (ids off the chain alone: k1_u1; U row loads in flight;
# bags split over k warps)
SWEEP = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4), (2, 8), (4, 4), (4, 8)]


def spread(samples: List[float]) -> dict:
    return dict(ms=statistics.median(samples), min=min(samples),
                max=max(samples))


def make_ids(kind, rows, bags, nnz, gen, dev) -> torch.Tensor:
    if kind == "tables":  # the trainer's flat lookup over 8 stacked tables
        per = rows // 8
        ids = torch.randint(0, per, (bags // 8, 8, nnz), generator=gen,
                            device=dev, dtype=torch.int32)
        offs = torch.arange(8, device=dev, dtype=torch.int32) * per
        return (ids + offs[None, :, None]).reshape(bags, nnz)
    if kind == "zipf":
        from param_tpu_torch.experiments.coalesce import stage_b_ids
        ids = stage_b_ids(np.random.default_rng(0), "zipf", bags, rows)
        return torch.from_numpy(ids).to(dev)
    return torch.randint(0, rows, (bags, nnz), generator=gen, device=dev,
                         dtype=torch.int32)


def time_case(case, dev, smi, sweep: bool) -> dict:
    name, rows, dim, dtype, bags, nnz, kind, iters = case
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((rows, dim), generator=gen, device=dev).to(dtype)
    base = make_ids(kind, rows, bags, nnz, gen, dev)
    ids = [((base.long() + s) % rows).to(torch.int32) for s in range(SHIFTS)]
    rtol = 1e-5 if dtype == torch.float32 else 8e-3
    got = emb_gather_cuda(table, ids[0])
    again = emb_gather_cuda(table, ids[0])
    want = emb_gather_plain(table, ids[0]).float()
    torch.cuda.synchronize(dev)
    err = (got.float() - want).abs().max().item()
    tol = rtol * want.abs().max().item()
    es = table.element_size()
    uniq = torch.unique(ids[0]).numel()  # shifts are bijections: same count
    nbytes = uniq * dim * es + bags * nnz * 4 + bags * dim * es
    b_ms, b_by = bound_ms(nbytes, bags * nnz * dim)
    k_ids, l_ids = itertools.cycle(ids), itertools.cycle(
        [i.long() for i in ids])
    with torch.no_grad():
        t = spread(time_samples(lambda: emb_gather_cuda(table, next(k_ids)),
                                iters, dev, reps=5, graph=True))
        lib = spread(time_samples(
            lambda: F.embedding_bag(next(l_ids), table, mode="sum"), iters,
            dev, reps=5, graph=True))
    sched = getattr(k1, "launch_schedule", None)  # absent in the parent
    bits = torch.int16 if es == 2 else torch.int32
    rec = dict(
        case=name, shape=f"table ({rows}, {dim}) {str(dtype)[6:]}, {bags} "
        f"bags x {nnz} ({kind})", k1=t, embedding_bag=lib, bound_ms=b_ms,
        bound_by=b_by, share=b_ms / t["ms"], unique_rows=uniq, bytes=nbytes,
        max_abs_err=err, tol=tol, ok=bool(err <= tol),
        repeats_bitwise=torch.equal(got.view(bits), again.view(bits)),
        schedule=sched(table, bags, nnz, bindings.vec_width(
            dim, es, table, got))._asdict() if sched else None,
        card=smi)
    if sweep:
        rec["sweep"] = {}
        for k, u in SWEEP:
            with k1.forced_schedule(k, u), torch.no_grad():
                out = emb_gather_cuda(table, ids[0]).float()
                e = (out - want).abs().max().item()
                s = spread(time_samples(
                    lambda: emb_gather_cuda(table, next(k_ids)), iters, dev,
                    reps=5, graph=True))
            rec["sweep"][f"k{k}_u{u}"] = dict(s, ok=bool(e <= tol))
    return rec


def one_tree(label: str, sweep: bool) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("emb_gather_timings: needs an NVIDIA GPU (it times "
                         "the card's kernel)")
    dev = torch.device("cuda")
    smi = nvidia_smi_name_power(0)
    for case in CASES:
        rec = time_case(case, dev, smi, sweep)
        rec["tree"] = label
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"tree": label, "ptxas": build.kernel_resources(
        "emb_gather"), "card": smi}), flush=True)
    return 0


def in_turns(parent: str, sweep: bool) -> int:
    """parent, this, this, parent (then, with ``sweep``, this once more
    with the sweep, so the turns run alike); one line per shape with
    both."""
    runs = {"parent": [], "change": [], "sweep": []}
    turns = ["parent", "change", "change", "parent"] + (["sweep"] if sweep
                                                        else [])
    for label in turns:
        root = os.path.abspath(parent) if label == "parent" else ROOT
        argv = [sys.executable, HERE, "--label", label]
        argv += ["--sweep"] if label == "sweep" else []
        r = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=root))
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr)
            return r.returncode
        runs[label].append({rec["case"]: rec for rec in map(
            json.loads, r.stdout.splitlines()) if "case" in rec})
    for name in runs["change"][0]:
        p = [run[name]["k1"] for run in runs["parent"]]
        c = [run[name]["k1"] for run in runs["change"]]
        bound = runs["change"][0][name]["bound_ms"]
        print(json.dumps(dict(
            summary=name, parent_ms=[t["ms"] for t in p],
            change_ms=[t["ms"] for t in c],
            ratio=statistics.mean(t["ms"] for t in c)
            / statistics.mean(t["ms"] for t in p),
            faster_beyond_spread=max(t["max"] for t in c)
            < min(t["min"] for t in p),
            slower_beyond_spread=min(t["min"] for t in c)
            > max(t["max"] for t in p),
            bound_ms=bound, share=[bound / t["ms"] for t in c],
            parent_share=[bound / t["ms"] for t in p],
            card=runs["change"][0][name]["card"])), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m param_tpu_torch.experiments.emb_gather_timings",
        description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="another checkout, timed in turns with this one")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other warps a bag and rows in flight")
    ap.add_argument("--label", default="change", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.parent:
        return in_turns(args.parent, args.sweep)
    return one_tree(args.label, args.sweep)


if __name__ == "__main__":
    raise SystemExit(main())
