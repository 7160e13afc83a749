"""Host wall time a step spends inside the port's step call (no
synchronize): the median over the traced run's unprofiled steps, pooled
over the ranks."""

import statistics

NAME = "step_host_ms"
UNIT = "ms"
LAYER = "model step (models/dlrm.py)"
MOVES = "samples_per_s"


def read(run):
    return statistics.median(ms for r in run["ranks"] for ms in r["host_ms"])
