"""Samples trained in the window over the window's time (host clock; the
window ends in a synchronize).  On several cards: the global batch, over
the slowest rank's window."""

NAME = "samples_per_s"
UNIT = "samples/s"


def read(run):
    ranks = run["ranks"]
    batch = run["cell"].traffic["batch"]
    return batch * ranks[0]["n_steps"] / max(r["window_s"] for r in ranks)
