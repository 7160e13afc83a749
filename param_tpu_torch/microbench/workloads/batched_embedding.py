"""Batched-table embedding operator (port of
``param_tpu/microbench/workloads/batched_embedding.py``).

Counterpart of the reference's fbgemm workload
(``workloads/pytorch/split_table_batched_embeddings_ops.py:33-329``): one op
that looks up T tables.  Build args: (num_tables, rows, dim, pooling);
forward args: (indices[B, T, nnz],) int32.  Each table is one call of
``ops/embedding.embedding_bag``, so a forward on the card launches K1 T
times; mean pooling divides the sum by nnz.
"""

from __future__ import annotations

import torch

from param_tpu_torch.microbench.operator import OperatorInterface, register_operator
from param_tpu_torch.ops.embedding import embedding_bag


class BatchedEmbeddingOp(OperatorInterface):
    def __init__(self):
        self.tables = None
        self.pooling = "sum"

    def build(self, num_tables=1, rows=1000, dim=64, pooling="sum"):
        """(T, R, D) f32 standard-normal tables drawn on the host from a
        generator seeded 0, then moved to the op's device."""
        g = torch.Generator().manual_seed(0)
        self.tables = torch.randn((num_tables, rows, dim), generator=g,
                                  dtype=torch.float32).to(self.device)
        self.pooling = pooling

    def forward(self, indices):
        assert self.tables is not None, "build() first"
        nnz = indices.shape[-1]
        indices = indices.to(torch.int32)  # K1 takes int32 ids
        outs = []
        for t in range(self.tables.shape[0]):
            out = embedding_bag(self.tables[t], indices[:, t])
            outs.append(out / nnz if self.pooling == "mean" else out)
        return torch.stack(outs, dim=1)  # (B, T, D)

    def cleanup(self):
        self.tables = None


register_operator("BatchedEmbedding", BatchedEmbeddingOp())
# reference workload name alias
register_operator("SplitTableBatchedEmbeddingBagsCodegen", BatchedEmbeddingOp())
