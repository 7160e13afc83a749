"""The DLRM dot interaction (``csrc/interaction.cu``), forward and backward,
and their plain PyTorch versions.

Forward: ``bot_out`` (B, D) and ``pooled`` (B, T, D) -> (B, D + P), the
bottom output then the dots of the rows of ``z = [bot_out; pooled]``
(m = T + 1 rows a sample) over the P = m (m - 1) / 2 pairs i > j of the
strict lower triangle, in row-major order (``jnp.tril_indices(m, k=-1)``;
the reference, ``param_tpu/models/dlrm.py:105-116``).  Backward: the
output's gradient ``grad`` (B, D + P) -> ``(g_bot, g_pooled)``, with G the
symmetric (m, m) matrix of the pairs' gradients (zero diagonal):
``g_z = G z``, ``g_bot = grad[:, :D] + g_z[:, 0]``, ``g_pooled = g_z[:,
1:]``, both contiguous.

On the card each direction is one kernel that reads ``bot_out`` and
``pooled`` where they lie: no z in device memory, no (B, m, m) products,
no index backward.  The forward takes a warp a sample, z in shared
memory 128 columns at a time, wherever a block's two copies and the dots
fit its shared memory (:func:`fwd_smem_bytes`); the backward a group of
:func:`interaction_lanes` lanes a sample and 128 columns, four columns a
lane, every row of z in registers, up to m = :data:`MAX_ROWS`.  Past those
the tiled pair (:func:`interaction_tiled`) stages z through shared memory
in tiles of 32 rows and holds any m and D (``csrc/interaction.cu``'s
notes).  f32, bf16 or f16, summed in f32 and
rounded to the inputs' type once.  Every sum runs in the order of the
composition's ``bmm``: one FMA chain over the contracted index, ascending
(the backward's as two chains, the rows before and after, then added), so
the two pairs give the same bits where both apply, and in f32 the kernels
give the composition's bits wherever cuBLAS sums that way (at the terabyte
widths, m 27, D 128).  Their ops are
``torch.ops.param_tpu_torch.dot_interaction`` and ``::dot_interaction_bwd``
(CPU kernels: the plain versions), which a captured execution trace of a
model on the card records and its replay runs on either device.  While a
profiler runs, the forward kernel's wrapper adds the samples it served to
the counter ``dlrm.interaction_rows``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from param_tpu_torch.kernels import bindings, launch_counts
from param_tpu_torch.utils.profiler import count

MAX_ROWS = 32  # m = T + 1: the backward's rows of z in a lane's registers
MAX_SMEM = 232448  # bytes of shared memory an H100 block may opt into
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def interaction_lanes(dim: int) -> int:
    """The backward's lanes a sample: four columns a lane, a power of two
    from 8 to 32 (a block a 128 columns)."""
    return min(32, max(8, 1 << (-(-dim // 4) - 1).bit_length()))


def fwd_smem_bytes(m: int, dim: int) -> int:
    """Shared memory of a forward block (``csrc/interaction.cu``'s
    ``fwd_smem_bytes``): two samples' rows of z (m rounded up to 4) a chunk
    of columns wide (D rounded up to 32, at most 128), and their dots (P
    rounded up to 4), in f32."""
    rows = 4 * -(-m // 4)
    cols = min(128, 32 * -(-dim // 32))
    return 2 * 4 * (rows * cols + 4 * -(-(m * (m - 1) // 2) // 4))


def interaction_tiled(m: int, dim: int) -> Tuple[bool, bool]:
    """Whether (m, dim) takes the tiled forward and backward: the forward
    where its block's shared memory would pass :data:`MAX_SMEM`, the
    backward past :data:`MAX_ROWS` rows."""
    return fwd_smem_bytes(m, dim) > MAX_SMEM, m > MAX_ROWS


def _check(bot_out: torch.Tensor, pooled: torch.Tensor) -> None:
    if bot_out.dim() != 2 or pooled.dim() != 3:
        raise ValueError("bot_out (B, D) and pooled (B, T, D) expected")
    if (pooled.shape[0] != bot_out.shape[0]
            or pooled.shape[2] != bot_out.shape[1]):
        raise ValueError(f"bot_out {tuple(bot_out.shape)} and pooled "
                         f"{tuple(pooled.shape)} disagree")


def _check_cuda(bot_out: torch.Tensor, pooled: torch.Tensor) -> None:
    _check(bot_out, pooled)
    if bot_out.device != pooled.device:
        raise ValueError("bot_out and pooled must share a device")
    if bot_out.dtype != pooled.dtype or bot_out.dtype not in DTYPES:
        raise TypeError(f"the interaction kernels take f32, bf16 or f16 "
                        f"inputs of one dtype, got {bot_out.dtype} and "
                        f"{pooled.dtype}")


def _vec(dim: int, *tensors: torch.Tensor) -> int:
    """1 where every row's four-element groups are aligned vector accesses."""
    return int(dim % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors))


def dot_interaction_plain(bot_out: torch.Tensor,
                          pooled: torch.Tensor) -> torch.Tensor:
    """Plain forward: concatenation, ``bmm``, the triangle's gather."""
    _check(bot_out, pooled)
    z = torch.cat([bot_out[:, None, :], pooled], dim=1)  # (B, m, D)
    zz = torch.bmm(z, z.transpose(1, 2))
    m = z.shape[1]
    li, lj = torch.tril_indices(m, m, offset=-1, device=z.device)
    return torch.cat([bot_out, zz[:, li, lj]], dim=1)


def dot_interaction_bwd_plain(grad: torch.Tensor, bot_out: torch.Tensor,
                              pooled: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: the triangle's gradients G by assignment (the pairs
    are distinct), then ``bmm(G, z) + bmm(G^T, z)``, the two products the
    forward's autograd takes."""
    _check(bot_out, pooled)
    B, D = bot_out.shape
    z = torch.cat([bot_out[:, None, :], pooled], dim=1)
    m = z.shape[1]
    li, lj = torch.tril_indices(m, m, offset=-1, device=z.device)
    g = grad.new_zeros((B, m, m))
    g[:, li, lj] = grad[:, D:]
    gz = torch.bmm(g, z) + torch.bmm(g.transpose(1, 2), z)
    return grad[:, :D] + gz[:, 0], gz[:, 1:].contiguous()


def dot_interaction_cuda(bot_out: torch.Tensor, pooled: torch.Tensor,
                         tiled: Optional[bool] = None) -> torch.Tensor:
    """The forward kernel on the inputs' CUDA device; ``tiled`` forces a
    kernel (default :func:`interaction_tiled`'s first)."""
    _check_cuda(bot_out, pooled)
    bot_out, pooled = bot_out.contiguous(), pooled.contiguous()
    B, D = bot_out.shape
    m = pooled.shape[1] + 1
    if tiled is None:
        tiled = interaction_tiled(m, D)[0]
    out = bot_out.new_empty((B, D + m * (m - 1) // 2))
    if B == 0 or D == 0:  # no rows, or dots of empty rows
        return out.zero_()
    rc = bindings.entry("interaction", "dot_interaction_fwd")(
        bindings.DTYPE_CODES[bot_out.dtype], bot_out.data_ptr(),
        pooled.data_ptr(), out.data_ptr(), B, m, D,
        _vec(D, bot_out, pooled), int(tiled), bindings.stream_of(out))
    bindings.check(rc, "dot_interaction")
    launch_counts["dot_interaction"] += 1
    if tiled:
        launch_counts["dot_interaction_tiled"] += 1
    count("dlrm.interaction_rows", B)
    return out


def dot_interaction_bwd_cuda(grad: torch.Tensor, bot_out: torch.Tensor,
                             pooled: torch.Tensor,
                             tiled: Optional[bool] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel on the inputs' CUDA device; ``tiled`` forces a
    kernel (default :func:`interaction_tiled`'s second)."""
    _check_cuda(bot_out, pooled)
    B, D = bot_out.shape
    m = pooled.shape[1] + 1
    if grad.shape != (B, D + m * (m - 1) // 2):
        raise ValueError(f"grad must be {(B, D + m * (m - 1) // 2)}, got "
                         f"{tuple(grad.shape)}")
    if grad.dtype != bot_out.dtype or grad.device != bot_out.device:
        raise TypeError("grad must have the inputs' dtype and device")
    if tiled is None:
        tiled = interaction_tiled(m, D)[1]
    grad = grad.contiguous()
    bot_out, pooled = bot_out.contiguous(), pooled.contiguous()
    g_bot, g_pooled = torch.empty_like(bot_out), torch.empty_like(pooled)
    if B == 0 or D == 0:
        return g_bot, g_pooled
    lanes = interaction_lanes(D)
    rc = bindings.entry("interaction", "dot_interaction_bwd")(
        bindings.DTYPE_CODES[bot_out.dtype], grad.data_ptr(),
        bot_out.data_ptr(), pooled.data_ptr(), g_bot.data_ptr(),
        g_pooled.data_ptr(), B, m, D, lanes.bit_length() - 1,
        _vec(D, bot_out, pooled, g_bot, g_pooled), int(tiled),
        bindings.stream_of(grad))
    bindings.check(rc, "dot_interaction_bwd")
    launch_counts["dot_interaction_bwd"] += 1
    if tiled:
        launch_counts["dot_interaction_bwd_tiled"] += 1
    return g_bot, g_pooled


def _fwd_meta(bot_out, pooled):
    m = pooled.shape[1] + 1
    return bot_out.new_empty((bot_out.shape[0],
                              bot_out.shape[1] + m * (m - 1) // 2))


def _bwd_meta(grad, bot_out, pooled):
    return torch.empty_like(bot_out), torch.empty_like(pooled)


_LIB = torch.library.Library("param_tpu_torch", "FRAGMENT")
_LIB.define("dot_interaction(Tensor bot_out, Tensor pooled) -> Tensor")
_LIB.define("dot_interaction_bwd(Tensor grad, Tensor bot_out, Tensor pooled)"
            " -> (Tensor, Tensor)")
_LIB.impl("dot_interaction", dot_interaction_cuda, "CUDA")
_LIB.impl("dot_interaction", dot_interaction_plain, "CPU")
_LIB.impl("dot_interaction", _fwd_meta, "Meta")
_LIB.impl("dot_interaction_bwd", dot_interaction_bwd_cuda, "CUDA")
_LIB.impl("dot_interaction_bwd", dot_interaction_bwd_plain, "CPU")
_LIB.impl("dot_interaction_bwd", _bwd_meta, "Meta")

