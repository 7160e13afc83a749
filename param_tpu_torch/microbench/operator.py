"""Operator registry and interface (port of
``param_tpu/microbench/operator.py``).

Counterpart of the reference's ``lib/operator.py:8-68``
(``OperatorInterface``, global ``op_map``, ``register_operator(s)``) plus
auto-wrapping of dotted ``torch.*`` paths (:class:`TorchPathOp`, the
reference's TorchScriptOp, ``lib/pytorch/benchmark.py:58-73``; the JAX
package wraps ``jax.*`` paths the same way).

Every operator has a ``device``: the run's device, set by the executor
before ``build``; a built ``nn.Module`` lives there.  Unset, it is the card
(``resolve_device("cuda")``, which raises without one): the host only when
the caller sets it.
"""

from __future__ import annotations

import importlib
import logging
import math
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Optional

import torch

from param_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


class OperatorInterface(ABC):
    """build -> forward (-> grad by autograd) -> cleanup."""

    _device: Optional[torch.device] = None

    @property
    def device(self) -> torch.device:
        if self._device is None:
            return resolve_device("cuda")
        return self._device

    @device.setter
    def device(self, value) -> None:
        self._device = resolve_device(value)

    def build(self, *args, **kwargs) -> None:  # noqa: B027
        pass

    @abstractmethod
    def forward(self, *args, **kwargs): ...

    def cleanup(self) -> None:  # noqa: B027
        pass


class CallableOp(OperatorInterface):
    """Wraps a plain function (reference: operator_impl.CallableOp:63)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


class UnaryOp(CallableOp):
    """The reference's in-place ops; the functional call stands in, as in
    the JAX package (reference: operator_impl.UnaryOp:15)."""


def init_flax_style(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` from ``generator`` with flax's
    default initialisers: biases zero, other 1-D parameters (norm scales)
    one, kernels lecun-normal (std 1 / sqrt(fan_in), fan_in = the
    parameter's size over its leading output dimension; not truncated)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() < 2:
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                draw = torch.randn(p.shape, generator=generator,
                                   dtype=torch.float32)
                p.copy_(draw / math.sqrt(fan_in))


class BuildableOp(OperatorInterface):
    """Constructor + call, e.g. an ``nn.Module`` built from build args
    (reference: operator_impl.BuildableOp:116).  A module's parameters are
    drawn from a ``torch.Generator`` seeded 0 (:func:`init_flax_style`) on
    the host and moved to the op's device, so the card and the CPU build
    the same numbers."""

    def __init__(self, ctor: Callable):
        self.ctor = ctor
        self.obj: Optional[Any] = None

    def build(self, *args, **kwargs):
        obj = self.ctor(*args, **kwargs)
        if isinstance(obj, torch.nn.Module):
            init_flax_style(obj, torch.Generator().manual_seed(0))
            obj = obj.to(self.device)
        self.obj = obj

    def forward(self, *args, **kwargs):
        assert self.obj is not None, "build() must run before forward()"
        return self.obj(*args, **kwargs)

    def cleanup(self):
        self.obj = None


class TorchPathOp(CallableOp):
    """Resolve a dotted path like ``torch.tanh`` / ``torch.nn.functional.
    silu`` at build time, the TorchScriptOp analogue: any public torch
    function benchmarks without a bespoke registration."""

    def __init__(self, path: str):
        parts = path.split(".")
        for split in range(len(parts) - 1, 0, -1):
            try:
                mod = importlib.import_module(".".join(parts[:split]))
            except ImportError:
                continue
            obj = mod
            try:
                for attr in parts[split:]:
                    obj = getattr(obj, attr)
            except AttributeError:
                continue
            if callable(obj):
                super().__init__(obj)
                return
        raise ValueError(f"cannot resolve operator path {path!r}")


op_map: Dict[str, OperatorInterface] = {}


def register_operator(name: str, op: OperatorInterface) -> None:
    """(reference: lib/operator.py register_operator)"""
    if name in op_map:
        log.warning("operator %s already registered; overwriting", name)
    op_map[name] = op


def register_operators(ops: Dict[str, OperatorInterface]) -> None:
    for name, op in ops.items():
        register_operator(name, op)


def get_operator(name: str) -> OperatorInterface:
    """Registered op, or an auto-wrapped dotted ``torch.*`` path.  A
    ``jax.*`` / ``jnp.*`` name the workloads do not register raises: the
    port has no JAX to resolve it in."""
    if name in op_map:
        return op_map[name]
    if name.startswith("torch."):
        op = TorchPathOp(name)
        op_map[name] = op
        return op
    raise ValueError(f"unknown operator {name!r} (and not a torch.* path)")


def load_workloads() -> None:
    """Auto-discover bundled workload modules
    (reference: init_helper.load_modules:42)."""
    import pkgutil

    import param_tpu_torch.microbench.workloads as pkg

    for info in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{info.name}")
