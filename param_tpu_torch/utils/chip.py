"""Published peak rates of the card the port targets, for kernel bounds.

NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.  A
card capped below that runs slower under load; the bound stays the published
one and the card's limit is reported beside every measured time.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bytes_per_s: float
    bf16_flops: float
    fp32_flops: float  # outside the tensor cores
    hbm_bytes: float


H100 = ChipSpec("H100 SXM", 3.35e12, 989e12, 67e12, 80e9)


def bound_ms(nbytes: float, flops: float = 0.0, fp32: bool = True,
             spec: ChipSpec = H100):
    """Least time in ms the card could take for work that moves ``nbytes``
    and does ``flops``; returns ``(ms, "bytes" | "operations")``."""
    t_bytes = nbytes / spec.hbm_bytes_per_s
    t_ops = flops / (spec.fp32_flops if fp32 else spec.bf16_flops)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"
