"""The communication layer: the backend ABC and the ``torch.distributed``
backend (NCCL on the card, gloo on the CPU)."""

from param_tpu_torch.backend.base import (  # noqa: F401
    OBJECT_COLLECTIVES,
    REDUCE_OPS,
    SUPPORTED_COLLECTIVES,
    Backend,
    CollectiveArgs,
    CommGroup,
    get_backend_cls,
    register_backend,
)
from param_tpu_torch.backend.dist_backend import DistBackend  # noqa: F401
