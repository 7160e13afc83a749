"""Published peak rates of the card the port targets, for kernel bounds and
roofline fractions (torch counterpart of ``param_tpu/utils/chip.py``).

NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit: bf16
and fp16 989 TF/s, int8 1979 TOP/s, f32 67 TF/s outside the tensor cores
(the port keeps TF32 off), HBM 3.35 TB/s.  A card capped below that runs
slower under load; the bound stays the published one and the card's limit
is reported beside every measured time.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bytes_per_s: float
    bf16_flops: float  # also fp16
    fp32_flops: float  # outside the tensor cores
    hbm_bytes: float
    int8_ops: float

    @property
    def hbm_gbs(self) -> float:
        return self.hbm_bytes_per_s / 1e9


H100 = ChipSpec("H100 SXM", 3.35e12, 989e12, 67e12, 80e9, 1979e12)
# placeholder rates for CPU runs (the reference's "cpu" entry): they keep the
# benches' roofline column defined and are no measurement of any CPU
CPU = ChipSpec("cpu", 50e9, 1e12, 0.5e12, 64e9, 1e12)


def detect_chip(device="cuda") -> ChipSpec:
    """The spec of ``device``: CPU for a CPU device, else by the card's name
    (``torch.cuda.get_device_name``); raises for a card with no spec."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return CPU
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return H100
    raise ValueError(f"no published peaks recorded for {name!r}")


def matmul_roofline_tflops(spec: ChipSpec, dtype_name: str) -> float:
    """Peak TF/s of a matmul in ``dtype_name`` (bf16/f16 on the tensor
    cores, int8, else f32 on the CUDA cores)."""
    if "bfloat16" in dtype_name or "float16" in dtype_name:
        return spec.bf16_flops / 1e12
    if "int8" in dtype_name:
        return spec.int8_ops / 1e12
    return spec.fp32_flops / 1e12


def bound_ms(nbytes: float, flops: float = 0.0, fp32: bool = True,
             spec: ChipSpec = H100):
    """Least time in ms the card could take for work that moves ``nbytes``
    and does ``flops``; returns ``(ms, "bytes" | "operations")``."""
    t_bytes = nbytes / spec.hbm_bytes_per_s
    t_ops = flops / (spec.fp32_flops if fp32 else spec.bf16_flops)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"
