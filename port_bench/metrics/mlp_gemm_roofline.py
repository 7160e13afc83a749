"""The FLOPs of ``step_mfu`` over the card's float32 peak, over the time of
the kernels launched under ``aten::mm`` / ``aten::addmm`` / ``aten::bmm``
(cuBLAS) in the traced steps."""

from port_bench.counts import PEAK

NAME = "mlp_gemm_roofline"
UNIT = "%"
LAYER = "ops: MLPs (ops/mlp.py)"
MOVES = "samples_per_s"


def read(run):
    ranks = [r for r in run["ranks"] if r.get("trace")]
    us = sum(r["trace"]["class_us"].get("gemm", 0.0) for r in ranks)
    if not us:
        return None
    flops = sum(r["flops_step"] * r["traced_steps"] for r in ranks)
    return 100.0 * (flops / PEAK["f32_flops"]) / (us / 1e6)
