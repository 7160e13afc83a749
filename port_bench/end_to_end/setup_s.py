"""Process start to the first timed step: imports, the CUDA context, the
kernel libraries, weights, batches, the checked steps and warm-up; on
several cards, to the last rank's window start."""

NAME = "setup_s"
UNIT = "s"


def read(run):
    return max(r["t_window_start"] for r in run["ranks"]) - run["t_start"]
