"""The row update's bytes (``counts.update_bytes``: each unique row and its
accumulator read and written once, its summed gradient and id read once)
over the card's memory bandwidth, over the time of the kernels launched
under ``param_tpu_torch::sparse_update`` (K2)."""

from port_bench.counts import PEAK

NAME = "row_update_roofline"
UNIT = "%"
LAYER = "kernels: K2 (kernels/sparse_update.py)"
MOVES = "samples_per_s"


def read(run):
    ranks = [r for r in run["ranks"] if r.get("trace")]
    us = sum(r["trace"]["class_us"].get("row_update", 0.0) for r in ranks)
    if not us:
        return None
    return 100.0 * (sum(r["update_bytes"] for r in ranks)
                    / PEAK["hbm_bytes_per_s"]) / (us / 1e6)
