"""Device ms a step in every operation that is neither under the port's two
ops, nor a GEMM, nor NCCL: the dedup's sort, gathers and segment sum, the
elementwise passes, the dense optimizer, copies and memsets; the mean over
the ranks."""

NAME = "eager_ops_ms"
UNIT = "ms"
LAYER = "ops: dedup, optimizers, interaction"
MOVES = "samples_per_s"


def read(run):
    ranks = [r for r in run["ranks"] if r.get("trace")]
    if not ranks:
        return None
    return sum(r["trace"]["class_us"].get("other", 0.0) / r["traced_steps"]
               for r in ranks) / len(ranks) / 1e3
