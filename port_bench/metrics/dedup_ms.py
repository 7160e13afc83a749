"""Device ms a step under the port's ``dlrm.dedup`` span: the pooled
gradient expanded to one row a lookup, then sorted, gathered, segment-summed
and scattered by row.  Read from ``param_tpu_torch.utils.profiler``'s span
record (CUDA events), one value a ``dlrm.step``, and the median taken: the
first profiled steps carry the profiler's start-up stalls, which a mean
spreads over the rest.  None where the program recorded no such span, or
where the rank ran in another process."""

import statistics

NAME = "dedup_ms"
UNIT = "ms"
LAYER = "ops: dedup, optimizers, interaction"
MOVES = "samples_per_s"
SPAN = "dlrm.dedup"


def read(run):
    try:
        from param_tpu_torch.utils.profiler import span_trees
    except ImportError:
        return None
    steps = [t for t in span_trees("dlrm.step") if SPAN in t]
    return statistics.median(t[SPAN] for t in steps) if steps else None
