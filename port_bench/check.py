"""The numbers that decide ``correct``, and how they are read from state.

Three numbers compare the program's first three steps with the reference's
(``reference.py``), each by its worst case:

- ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the three steps;
- ``grad_gap``: over the leaves (each table, each MLP weight and bias), the
  gap between the norm of the program's first gradient and the reference's,
  over the larger of that leaf's reference norm and the median leaf's;
- ``change_gap``: the same of each leaf's change after the three steps.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's move by round-off alone and are left out of it.

The program's first gradient is worked out from its state after one step:
``(p0 - p1) / lr`` under SGD, ``(p0 - p1) sqrt(a1 + eps) / lr`` under
Adagrad, where p0 is the seed's initial value, made again (``data.py``).
A reading on several ranks (a replicated leaf) counts by its worst rank.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NAMES = ("loss_gap", "grad_gap", "change_gap")


def _norm_gap(prog: Dict[str, List[float]], ref: Dict[str, List[float]],
              leaves) -> Tuple[float, str]:
    """(the worst leaf's gap, that leaf)."""
    ref_norm = {k: math.sqrt(ref[k][0]) for k in leaves}
    med = statistics.median(ref_norm.values())
    worst = (0.0, "")
    for k in leaves:
        scale = max(ref_norm[k], med)
        for p in prog[k]:
            gap = abs(math.sqrt(p) - ref_norm[k]) / scale
            if not math.isfinite(gap):
                return math.inf, k
            worst = max(worst, (gap, k))
    return worst


def gaps(prog: dict, ref: dict, leaves: bool = False) -> Dict[str, float]:
    """The three numbers of ``prog``'s readings against ``ref``'s; with
    ``leaves``, also the leaf each norm gap was read on."""
    if set(prog["grad_sq"]) != set(ref["grad_sq"]):
        raise ValueError("the program's and the reference's leaves differ")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if not all(map(math.isfinite, prog["loss"])):
        loss = math.inf
    g_norm = {k: math.sqrt(v[0]) for k, v in ref["grad_sq"].items()}
    med = statistics.median(g_norm.values())
    moved = [k for k in g_norm if g_norm[k] >= 1e-3 * med]
    grad, grad_leaf = _norm_gap(prog["grad_sq"], ref["grad_sq"], list(g_norm))
    change, change_leaf = _norm_gap(prog["change_sq"], ref["change_sq"],
                                    moved)
    out = {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
    if leaves:
        out.update(grad_leaf=grad_leaf, change_leaf=change_leaf)
    return out


def merge(parts: List[dict]) -> dict:
    """One set of readings from every rank's: each leaf's values in rank
    order; the losses, equal on every rank, from the first."""
    out = {"loss": parts[0]["loss"], "grad_sq": {}, "change_sq": {}}
    for key in ("grad_sq", "change_sq"):
        for p in parts:
            for leaf, v in p[key].items():
                out[key].setdefault(leaf, []).extend(v)
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number is a finite reading within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in NAMES)
