"""Algorithm- and bus-bandwidth formulas (the port's own copy of
``param_tpu/utils/bw.py``).

Single source of truth for the busBW correction factors (the reference
duplicates them in ``pytorch_backend_utils.py:200-247`` and
``et_replay/comm/profiler_trace_analysis.py:85-118``; here there is one table
shared by the live benchmarks and the post-hoc trace analysis).
"""

from __future__ import annotations


def alg_bw(size_bytes: int, lat_us: float) -> float:
    """Algorithmic bandwidth in GB/s: bytes moved / average iteration time.
    (reference: comms_utils.py:168-186)"""
    if lat_us <= 0:
        return 0.0
    return (size_bytes / 1.0e9) / (lat_us / 1.0e6)


def bus_bw_factor(collective: str, world_size: int) -> float:
    """nccl-tests bus-bandwidth correction factor.
    (reference: pytorch_backend_utils.py:200-247)"""
    n = max(1, world_size)
    c = collective
    if c in ("all_reduce",):
        return 2.0 * (n - 1) / n
    if c in (
        "all_to_all",
        "all_to_allv",
        "all_to_all_single",
        "all_gather",
        "all_gather_v",
        "all_gather_base",
        "all_gather_object",
        "reduce_scatter",
        "reduce_scatter_v",
        "reduce_scatter_base",
        "gather",
        "scatter",
    ):
        return (n - 1) / n
    # reduce, broadcast, incast, multicast, pt2pt: busBW == algBW
    return 1.0


def bus_bw(
    collective: str, size_bytes: int, lat_us: float, world_size: int, bitwidth: int = 32
) -> float:
    """busBW in GB/s, with quantized-communication scaling
    (reference: comms.py:1149 — busBW *= bitwidth/32)."""
    bw = alg_bw(size_bytes, lat_us) * bus_bw_factor(collective, world_size)
    if bitwidth != 32:
        bw *= bitwidth / 32.0
    return bw
