"""The cross net's FLOPs a step (``cross_flops`` of the trace counts: its
six GEMMs a layer, forward and backward) over the card's float32 peak,
over the device time a step of the port's ``dlrm.cross`` spans (every
cross layer's forward and backward, GEMMs and elementwise passes alike),
read from ``param_tpu_torch.utils.profiler``'s span record (CUDA events),
the median over the ``dlrm.step`` spans.  None where the program recorded
no such span, or where the rank ran in another process."""

import statistics

from port_bench.counts import PEAK

NAME = "cross_roofline"
UNIT = "%"
LAYER = "ops: dedup, optimizers, interaction"
MOVES = "samples_per_s"
SPAN = "dlrm.cross"


def read(run):
    try:
        from param_tpu_torch.utils.profiler import span_trees
    except ImportError:
        return None
    ranks = [r for r in run["ranks"] if r.get("cross_flops")]
    steps = [t for t in span_trees("dlrm.step") if SPAN in t]
    if not ranks or not steps:
        return None
    ms = statistics.median(t[SPAN] for t in steps)
    return 100.0 * (ranks[0]["cross_flops"] / PEAK["f32_flops"]) / (ms / 1e3)
