"""Operators of the port: embedding bag, sparse row update, MLP, matmuls,
attention, ring attention, ring collectives.  Importing them builds no
kernel."""

from param_tpu_torch.ops.matmul import (  # noqa: F401
    gemm_flops,
    matmul,
    matmul_pallas,
    matmul_weight_resident,
)
from param_tpu_torch.ops.embedding import (  # noqa: F401
    embedding_bag,
    embedding_bytes,
)
