"""Data generators: arg specs -> concrete values (port of
``param_tpu/microbench/data.py``).

Counterpart of the reference's ``lib/data.py`` + ``lib/pytorch/data_impl.py``
(``materialize_arg`` :33-128, ``PyTorch:DefaultDataGenerator`` :131).
Supported spec types: tensor, float/double, int/long, bool, str, none,
genericlist, tuple, device.

Tensors are drawn with the same numpy ``default_rng(seed)`` calls, in the
same order, as the JAX package's, and rounded the way it rounds them: a
float draw goes f64 -> f32 -> the spec's dtype (JAX's ``jnp.asarray`` keeps
f32 before ``.astype``), an integer draw int64 -> int32 -> the spec's
dtype.  So a bf16 tensor holds the same bits in both packages.  Tensors are
made on the host and moved to the run's device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Tuple, Type

import numpy as np
import torch

from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.dtypes import dtype_from_name


def materialize_arg(spec: Dict[str, Any], rng: np.random.Generator,
                    device="cuda"):
    """(reference: data_impl.materialize_arg:33-128); tensors on
    ``device`` (default the card, through ``resolve_device``), which is
    also what a ``device`` spec without a value gives."""
    device = resolve_device(device)
    t = spec["type"]
    if t == "tensor":
        dtype = dtype_from_name(spec.get("dtype", "float32"))
        shape = tuple(spec.get("shape", []))
        if dtype == torch.bool:
            arr = rng.integers(0, 2, size=shape).astype(bool)
        elif not dtype.is_floating_point:
            lo, hi = spec.get("low", 0), spec.get("high", 64)
            arr = rng.integers(lo, hi, size=shape).astype(np.int32)
        else:
            arr = rng.random(size=shape).astype(np.float32)
        return torch.from_numpy(np.array(arr)).to(
            device=device, dtype=dtype)
    if t in ("float", "double"):
        return float(spec.get("value", 0.0))
    if t in ("int", "long"):
        return int(spec.get("value", 0))
    if t == "bool":
        return bool(spec.get("value", False))
    if t == "str":
        return str(spec.get("value", ""))
    if t == "none":
        return None
    if t == "device":
        return spec.get("value", str(device))
    if t == "genericlist":
        return [materialize_arg(s, rng, device) for s in spec.get("value", [])]
    if t == "tuple":
        return tuple(materialize_arg(s, rng, device)
                     for s in spec.get("value", []))
    raise ValueError(f"unsupported arg type {t!r}")


class DataGenerator(ABC):
    """(reference: lib/data.py DataGenerator); ``device``: where tensors
    go (default the card, through ``resolve_device``)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    @abstractmethod
    def get_data(self, config: Dict[str, Any], seed: int = 0) -> Tuple[list, dict]:
        ...


class DefaultDataGenerator(DataGenerator):
    """(reference: PyTorch:DefaultDataGenerator, data_impl.py:131)"""

    def get_data(self, config: Dict[str, Any], seed: int = 0):
        rng = np.random.default_rng(seed)
        args = [materialize_arg(a, rng, self.device)
                for a in config.get("args", [])]
        kwargs = {k: materialize_arg(v, rng, self.device)
                  for k, v in config.get("kwargs", {}).items()}
        return args, kwargs


_GENERATORS: Dict[str, Type[DataGenerator]] = {}


def register_data_generator(name: str, cls: Type[DataGenerator]) -> None:
    """(reference: lib/data.py:27)"""
    _GENERATORS[name] = cls


def get_data_generator(name: str) -> Type[DataGenerator]:
    return _GENERATORS[name]


register_data_generator("DefaultDataGenerator", DefaultDataGenerator)
# the reference's and the JAX package's generator names, so that their
# configs load unchanged
register_data_generator("PyTorch:DefaultDataGenerator", DefaultDataGenerator)
register_data_generator("JAX:DefaultDataGenerator", DefaultDataGenerator)
