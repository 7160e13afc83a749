"""Device resolution for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``).  Without a GPU the
port refuses to run unless the caller asked for the CPU explicitly: it never
carries on silently on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for but absent.

    Also pins full-f32 matmuls (no TF32), matching the reference's
    ``preferred_element_type=float32`` dots."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def is_sm90(device="cuda") -> bool:
    """True when ``device`` is a Hopper (compute capability 9.0) GPU, the
    only target the hand-written kernels are compiled for (sm_90a)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) == (9, 0)


def require_sm90(device="cuda") -> None:
    if not is_sm90(device):
        cap = (torch.cuda.get_device_capability(torch.device(device))
               if torch.cuda.is_available() else None)
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (H100/H200); "
            f"device {device!r} has compute capability {cap}"
        )
