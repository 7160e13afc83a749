"""Small convnet workloads (port of
``param_tpu/microbench/workloads/convnets.py``).

Counterpart of the reference's ``workloads/pytorch/alex_net.py:49`` and
``resnet.py:278``: end-to-end model-forward operators, ``torch.nn`` modules
with the layer lists of the JAX package's flax models (``convnets.py:40-93``):
NHWC inputs, flax's ``"SAME"`` convolutions and ``VALID`` max pools, and
AlexNet flattened in NHWC order before its first dense layer, so that flax
parameters carry across unchanged (``models/convert.flax_params_from_jax``).
Submodules carry flax's auto-names (``Conv_0``, ``Dense_1``,
``BasicBlock_2``...).  As in flax, the parameters are made at the first
forward, when the input's channels (and AlexNet's flattened width) are
known; they are drawn from a generator seeded 0 on the host.  The
convolutions are XLA ops in the JAX package, so cuDNN (``F.conv2d``) runs
them here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from param_tpu_torch.microbench.operator import (
    OperatorInterface,
    init_flax_style,
    register_operator,
)
from param_tpu_torch.microbench.workloads.basic_ops import Conv, Dense, max_pool


def _pool(x):
    return max_pool(x, (3, 3), (2, 2))


def _valid_pool_size(n: int) -> int:
    return (n - 3) // 2 + 1


class AlexNet(torch.nn.Module):
    """flax AlexNet for (B, H, W, in_ch) inputs of ``spatial`` (H, W)."""

    def __init__(self, in_ch: int = 3, spatial=(224, 224),
                 num_classes: int = 1000):
        super().__init__()
        self.Conv_0 = Conv(in_ch, 64, (11, 11), (4, 4))
        self.Conv_1 = Conv(64, 192, (5, 5))
        self.Conv_2 = Conv(192, 384, (3, 3))
        self.Conv_3 = Conv(384, 256, (3, 3))
        self.Conv_4 = Conv(256, 256, (3, 3))
        h, w = (-(-s // 4) for s in spatial)  # SAME, stride 4
        for _ in range(3):
            h, w = _valid_pool_size(h), _valid_pool_size(w)
        self.Dense_0 = Dense(h * w * 256, 4096)
        self.Dense_1 = Dense(4096, 4096)
        self.Dense_2 = Dense(4096, num_classes)

    def forward(self, x):  # (B, H, W, C)
        x = _pool(F.relu(self.Conv_0(x)))
        x = _pool(F.relu(self.Conv_1(x)))
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = _pool(F.relu(self.Conv_4(x)))
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class BasicBlock(torch.nn.Module):
    def __init__(self, in_ch: int, features: int = 64):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, (3, 3))
        self.Conv_1 = Conv(features, features, (3, 3))
        self.Conv_2 = (Conv(in_ch, features, (1, 1)) if in_ch != features
                       else None)

    def forward(self, x):
        y = self.Conv_1(F.relu(self.Conv_0(x)))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return F.relu(x + y)


class ResNetSmall(torch.nn.Module):
    """flax SmallResNet: a 7x7 stride-2 stem, blocks of 64, 128, 256, a
    spatial mean and a 1000-way dense layer (any ``spatial`` size)."""

    def __init__(self, in_ch: int = 3, spatial=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, 64, (7, 7), (2, 2))
        chans = 64
        for i, f in enumerate((64, 128, 256)):
            setattr(self, f"BasicBlock_{i}", BasicBlock(chans, f))
            chans = f
        self.Dense_0 = Dense(256, 1000)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        for i in range(3):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(1, 2)))


class ModelOp(OperatorInterface):
    """A model built at the first forward from the input's shape (as flax
    initialises), parameters drawn from a generator seeded 0 on the host,
    then moved to the op's device; rebuilt when the input shape changes.
    ``model`` may also be set directly (carried-over parameters)."""

    def __init__(self, model_cls):
        self.model_cls = model_cls
        self.model = None
        self._shape = None

    def build(self, *args, **kwargs):
        self.model = None

    def forward(self, x):
        shape = (x.shape[-1], tuple(x.shape[1:3]))
        if self.model is None or self._shape not in (None, shape):
            model = self.model_cls(shape[0], shape[1])
            init_flax_style(model, torch.Generator().manual_seed(0))
            self.model = model.to(self.device)
        self._shape = shape
        return self.model(x)

    def cleanup(self):
        self.model = None
        self._shape = None


register_operator("AlexNet", ModelOp(AlexNet))
register_operator("ResNetSmall", ModelOp(ResNetSmall))
