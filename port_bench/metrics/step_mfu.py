"""FLOPs of the MLPs and the interaction, forward and backward, counted
from shapes (``counts.step_flops``), a second of the traced run's
unprofiled steps (CUDA-event step times), over the card's float32 peak
outside the tensor cores; the mean over the ranks."""

from port_bench.counts import PEAK

NAME = "step_mfu"
UNIT = "%"
LAYER = "model step (models/dlrm.py)"
MOVES = "samples_per_s"


def read(run):
    rates = [r["flops_step"] * len(r["quiet_device_ms"])
             / (sum(r["quiet_device_ms"]) / 1e3) for r in run["ranks"]]
    return 100.0 * sum(rates) / len(rates) / PEAK["f32_flops"]
