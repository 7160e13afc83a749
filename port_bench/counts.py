"""The work of one DLRM training step, counted from shapes and inputs.

Rooflines count what the inputs need, whatever implements it: each unique
row read once, ids read once, outputs written once.  So a faster design of
a kernel reads a higher share, and a design that reads more than it must
cannot push a share above 100%.
"""

from __future__ import annotations

from typing import List

PEAK = {
    # NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
    "f32_flops": 67e12,  # float32 outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}


def mlp_flops(dims: List[int], batch: int, input_grad: bool) -> int:
    """Forward and backward FLOPs of an MLP over ``batch`` rows: 2 b din
    dout a layer for the forward, as much for the weight gradient, and as
    much for the input gradient, except the first layer's where its input
    needs none (``input_grad`` False: the dense features)."""
    total = 0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        passes = 3 if (i > 0 or input_grad) else 2
        total += passes * 2 * batch * din * dout
    return total


def interaction_flops(cfg: dict, batch: int) -> int:
    """The dot interaction's batched product z z^T, (m, D) x (D, m) a row,
    m = tables + 1: one forward product and its two gradients."""
    m = cfg["num_tables"] + 1
    return 3 * 2 * batch * m * m * cfg["emb_dim"]


def step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of the dense half of a step on ``batch`` rows: both MLPs and
    the interaction, forward and backward."""
    from port_bench.data import mlp_dims

    dims = mlp_dims(cfg)
    return (mlp_flops(dims["bot"], batch, input_grad=False)
            + mlp_flops(dims["top"], batch, input_grad=True)
            + interaction_flops(cfg, batch))


def lookup_bytes(unique_rows: int, bags: int, nnz: int, dim: int,
                 elem: int = 4) -> int:
    """The pooled lookup: each unique row read once, the ids (4 bytes) read
    once, the pooled (bags, dim) output written once."""
    return unique_rows * dim * elem + bags * nnz * 4 + bags * dim * elem


def update_bytes(unique_rows: int, dim: int, adagrad: bool,
                 elem: int = 4) -> int:
    """The row update: each unique row (and its accumulator under Adagrad)
    read and written once, its summed gradient row and its id read once."""
    state = 2 if adagrad else 1
    return unique_rows * (dim * elem * (2 * state + 1) + 4)
