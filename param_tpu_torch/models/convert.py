"""Carry parameters over from the reference package's layout.

The reference's DLRM parameter tree ``{"tables": (T, E, D), "bot": [(W, b),
...], "top": [...]}`` (as numpy arrays) has the same layout as the port's, so
conversion is a copy to torch tensors on ``device``.  Used by the tests so
that both packages start from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from param_tpu_torch.utils.device import resolve_device


def _tensor(a, dev, requires_grad: bool) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return t.requires_grad_(requires_grad)


def _convert(tree, dev, requires_grad: bool):
    return {
        "tables": _tensor(tree["tables"], dev, requires_grad),
        "bot": [(_tensor(w, dev, requires_grad), _tensor(b, dev, requires_grad))
                for w, b in tree["bot"]],
        "top": [(_tensor(w, dev, requires_grad), _tensor(b, dev, requires_grad))
                for w, b in tree["top"]],
    }


def params_from_jax(np_params, device="cuda"):
    """The reference's parameter tree (numpy leaves) as the port's params:
    fresh tensors on ``device`` that require grad."""
    return _convert(np_params, resolve_device(device), True)


def adagrad_state_from_jax(np_acc, device="cuda"):
    """A params-shaped accumulator tree (numpy leaves; e.g. the reference's
    ``init_adagrad_state`` or optax's ``sum_of_squares``) as the port's
    Adagrad state."""
    return _convert(np_acc, resolve_device(device), False)
