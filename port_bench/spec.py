"""Finds the benchmark's parts by name.

A cell is ``workloads/<cell>.json`` (its configuration, traffic, chips, why
and the limits of its correctness check); a configuration is
``configs/<config>.json``, and its ``model`` key names its family,
``models/<model>.py`` (the program under test, its plain reference and the
work its trace counts); a traffic mix is ``traffic/<traffic>.json``; an
end-to-end metric is ``end_to_end/<metric>.py`` and a per-layer metric
``metrics/<metric>.py``, each a module with ``NAME``, ``UNIT``, ``LAYER``,
``MOVES`` and ``read(run)``, each listed in ``BENCHMARK.json``.  A later
change adds files and entries; none of this code needs an edit for a new
cell or metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]


def cell(name: str) -> Cell:
    """The cell ``name`` with its configuration and traffic.  Where
    ``BENCHMARK.json`` lists the cell, its entry must agree with the file."""
    w = load_json(os.path.join(HERE, "workloads", check_name(name) + ".json"))
    for entry in benchmark()["workloads"]:
        if entry["name"] == name:
            for key in ("config", "traffic", "chips", "why"):
                if entry[key] != w[key]:
                    raise ValueError(f"cell {name}: {key} differs between "
                                     f"BENCHMARK.json and workloads/")
    cfg = load_json(os.path.join(HERE, "configs",
                                 check_name(w["config"]) + ".json"))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     check_name(w["traffic"]) + ".json"))
    chips = int(w["chips"])
    if traffic["batch"] % chips:
        raise ValueError(f"cell {name}: batch {traffic['batch']} does not "
                         f"divide over {chips} chips")
    return Cell(name, cfg, traffic, chips, dict(w["limits"]))


def _module(folder: str, name: str):
    path = os.path.join(HERE, folder, check_name(name) + ".py")
    tag = re.sub(r"\W", "_", f"port_bench_{folder}_{name}")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} defines NAME {mod.NAME!r}")
    return mod


def model(name: str):
    """The module of the model family ``name`` (``models/<name>.py``)."""
    return _module("models", name)


def metrics(kind: str, cell_name: str) -> List:
    """The reader modules of the ``kind`` ("end_to_end" or "per_layer")
    metrics that ``BENCHMARK.json`` lists for cell ``cell_name``."""
    folder = "end_to_end" if kind == "end_to_end" else "metrics"
    return [_module(folder, m["name"]) for m in benchmark()[kind]
            if cell_name in m.get("workloads", [cell_name])]
