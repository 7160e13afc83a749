"""Reads what the limits of ``check.py`` are set from, on the card, at a
cell's own size: the program's three numbers over many seeds, and those of
the control and of the faults, each over the same seeds.

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,13 [--out F]

- program: the first three steps of the model family's program
  (``models/<model>.py``'s ``Program``), as a run drives them, against the
  reference;
- the family's ``controls``, each the reference with a change, in the
  program's place.  For DLRM: ``control``, every product in TF32 (the
  precision below the configuration's f32 with TF32 off); ``half_batch``,
  the second half of each shard's rows left out and the mean taken over the
  rest; ``exchange`` (several cards), the shards' dense gradients not
  averaged, as a step without its all-reduce would leave them.

Each reading comes with ``check.verdict`` against the cell's limits under
``correct``: the program's has to be true, every control's and fault's
false.  A state left unchanged reads 1 in ``change_gap`` by definition,
with no run.  The benchmark's own runs never run this.  One JSON line a
seed.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from port_bench import check, spec  # noqa: E402


def rank_readings(cell, seeds, rank, world, group, device, agree=None):
    """The program's checked readings on this rank for every seed."""
    import torch

    program = spec.model(cell.config["model"]).Program
    out = []
    for seed in seeds:
        prog = program(cell, seed, rank, world, group, device)
        out.append(prog.checked_steps())
        del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def calibrate(cell, seeds, device_type="cuda"):
    """One dict a seed: the gaps of the program, the control and the
    faults, each with its verdict under the cell's limits."""
    import torch

    from port_bench import run

    family = spec.model(cell.config["model"])

    device = (torch.device("cuda", 0) if device_type == "cuda"
              else torch.device("cpu"))
    if cell.chips == 1:
        ranks = [rank_readings(cell, seeds, 0, 1, None, device)]
    else:
        job = functools.partial(rank_readings, cell, seeds)
        ranks = run.run_ranks(cell.chips, job, device_type, deadline_s=3000)
    def judged(values):
        return {**values, "correct": check.verdict(values, cell.limits)}

    lines = []
    for i, seed in enumerate(seeds):
        def read(**kw):
            return family.reference_readings(cell.config, cell.traffic, seed,
                                             cell.chips, device, **kw)
        ref = read()
        line = {"seed": seed, "program": judged(check.gaps(
            check.merge([r[i] for r in ranks]), ref, leaves=True))}
        for name, kw in family.controls(cell.chips).items():
            line[name] = judged(check.gaps(read(**kw), ref, leaves=True))
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default=None, help="also append the lines here")
    ns = ap.parse_args(argv)
    cell = spec.cell(ns.workload)
    seeds = [int(s) for s in ns.seeds.split(",")]
    t0 = time.time()
    lines = calibrate(cell, seeds)
    for line in lines:
        line["workload"] = cell.name
        text = json.dumps(line)
        print(text)
        if ns.out:
            with open(ns.out, "a") as f:
                f.write(text + "\n")
    print(f"{len(seeds)} seeds in {time.time() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
