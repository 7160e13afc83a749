"""The 95th percentile (nearest rank) of every step of the window, each the
interval between CUDA events at consecutive step ends; on several cards
pooled over the ranks."""

import math

NAME = "step_ms_p95"
UNIT = "ms"


def read(run):
    steps = sorted(ms for r in run["ranks"] for ms in r["step_ms"])
    return steps[math.ceil(0.95 * len(steps)) - 1]
