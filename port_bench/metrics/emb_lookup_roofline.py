"""The pooled lookup's bytes (``counts.lookup_bytes``: unique rows, ids,
pooled output) over the card's memory bandwidth, over the time of the
kernels launched under ``param_tpu_torch::emb_gather`` (K1)."""

from port_bench.counts import PEAK

NAME = "emb_lookup_roofline"
UNIT = "%"
LAYER = "kernels: K1 (kernels/emb_gather.py)"
MOVES = "samples_per_s"


def read(run):
    ranks = [r for r in run["ranks"] if r.get("trace")]
    us = sum(r["trace"]["class_us"].get("emb_lookup", 0.0) for r in ranks)
    if not us:
        return None
    return 100.0 * (sum(r["lookup_bytes"] for r in ranks)
                    / PEAK["hbm_bytes_per_s"]) / (us / 1e6)
