"""Published peak rates of the card the port targets, for kernel bounds and
roofline fractions (torch counterpart of ``param_tpu/utils/chip.py``).

NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit: bf16
and fp16 989 TF/s, int8 1979 TOP/s, TF32 495 TF/s, f32 67 TF/s outside the
tensor cores, HBM 3.35 TB/s.  A card capped below that runs slower under
load; the bound stays the published one and the card's limit is reported
beside every measured time.

The port never computes an f32 product as one TF32 product (about 3
decimal digits).  Its f32 attention kernels (K6, K7) take each product as
three TF32 products of split operands, as accurate as f32, so the least
time the card could take for f32-accurate attention is at TF32 / 3, 165
TF/s (``split_tf32``); the f32 GEMM (K3) and the other f32 rows keep the
67 TF/s of the CUDA cores.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bytes_per_s: float
    bf16_flops: float  # also fp16
    fp32_flops: float  # outside the tensor cores
    hbm_bytes: float
    int8_ops: float
    tf32_flops: float  # dense, on the tensor cores

    @property
    def split_tf32_flops(self) -> float:
        """f32-accurate products on the tensor cores: three TF32 products
        each."""
        return self.tf32_flops / 3

    @property
    def hbm_gbs(self) -> float:
        return self.hbm_bytes_per_s / 1e9


H100 = ChipSpec("H100 SXM", 3.35e12, 989e12, 67e12, 80e9, 1979e12, 495e12)
# placeholder rates for CPU runs (the reference's "cpu" entry): they keep the
# benches' roofline column defined and are no measurement of any CPU; its
# split-TF32 rate is its f32 one, so CPU runs print the reference's column
CPU = ChipSpec("cpu", 50e9, 1e12, 0.5e12, 64e9, 1e12, 1.5e12)


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


def attention_roofline_tflops(spec: ChipSpec, dtype_name: str) -> float:
    """Peak TF/s of attention in ``dtype_name``: as
    :func:`matmul_roofline_tflops`, but f32 at the split-TF32 rate of K6 /
    K7."""
    if any(t in dtype_name for t in ("float16", "int8")):  # also bfloat16
        return matmul_roofline_tflops(spec, dtype_name)
    return spec.split_tf32_flops / 1e12


def bound_ms(nbytes: float, flops: float = 0.0, fp32: bool = True,
             spec: ChipSpec = H100, split_tf32: bool = False):
    """Least time in ms the card could take for work that moves ``nbytes``
    and does ``flops`` (16-bit, or f32: on the CUDA cores, or with
    ``split_tf32`` f32-accurate on the tensor cores); returns ``(ms,
    "bytes" | "operations")``."""
    t_bytes = nbytes / spec.hbm_bytes_per_s
    rate = (spec.bf16_flops if not fp32 else
            spec.split_tf32_flops if split_tf32 else spec.fp32_flops)
    t_ops = flops / rate
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def nvidia_smi_name_power(index: int = 0) -> Optional[str]:
    """Card ``index``'s ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    None where nvidia-smi cannot be run."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", f"--id={index}"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else None
