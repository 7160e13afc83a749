"""The communication layer: the backend ABC, the ``torch.distributed``
backend (NCCL on the card, gloo on the CPU), the torchcomms-style facade
over it and the mock backend."""

from param_tpu_torch.backend.base import (  # noqa: F401
    OBJECT_COLLECTIVES,
    PT2PT_PATTERNS,
    REDUCE_OPS,
    SUPPORTED_COLLECTIVES,
    SUPPORTED_P2P_OPS,
    Backend,
    CollectiveArgs,
    CommGroup,
    get_backend_cls,
    list_backends,
    register_backend,
)
from param_tpu_torch.backend.dist_backend import DistBackend  # noqa: F401
from param_tpu_torch.backend.mock_backend import MockBackend  # noqa: F401
from param_tpu_torch.backend.torchcomms import (  # noqa: F401
    ReduceOp,
    TorchComm,
    TorchcommsBackend,
    new_comm,
)
