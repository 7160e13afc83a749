"""NCCL kernel ms a step on each rank not covered by any other device
operation (the id and pooled all-to-alls and the MLP all-reduces of
``backend/dist_backend.py``), the mean over the ranks.  Nothing to read on
one card."""

NAME = "comm_exposed_ms"
UNIT = "ms"
LAYER = "backend (backend/dist_backend.py)"
MOVES = "samples_per_s"


def read(run):
    vals = [r["trace"]["comm_exposed_us"] / r["traced_steps"]
            for r in run["ranks"]
            if r.get("trace") and r["trace"].get("comm_exposed_us") is not None]
    if not vals:
        return None
    return sum(vals) / len(vals) / 1e3
