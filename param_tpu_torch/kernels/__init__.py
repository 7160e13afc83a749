"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

- K1 :mod:`.emb_gather` (``csrc/emb_gather.cu``): sum-pooled embedding bag.
- K2 :mod:`.sparse_update` (``csrc/sparse_update.cu``): in-place SGD /
  Adagrad row update.
- :mod:`.dedup` (``csrc/dedup.cu``): the sparse step's segment sum of the
  pooled gradient by row id, in sorted order (no TPU kernel: the JAX
  package leaves its dedup to XLA).
- :mod:`.interaction` (``csrc/interaction.cu``): the DLRM dot interaction,
  one kernel each way (no TPU kernel: the JAX package leaves it to XLA).
- K3 and K4 :mod:`.gemm` (``csrc/gemm.cu``, ``csrc/hopper.cuh``): tiled
  GEMM (wgmma / TMA for bf16 and f16, mma.sync where TMA cannot read the
  rows, an FMA core for f32; split K for small grids); stacked GEMMs
  sharing one weight.
- K5 :mod:`.int4_gemm` (``csrc/int4_gemm.cu``, ``csrc/hopper.cuh``): x @
  group-int4 weights; four paths picked by ``int4_schedule`` (a weight
  stream for M <= 32, on mma.sync up to M = 8 and register-A wgmma
  above, wgmma / TMA above M = 32, mma.sync where 16-byte copies cannot
  read the rows, the CUDA cores for g % 16 != 0).
- K6 :mod:`.flash_fwd` (``csrc/flash_fwd.cu``, ``csrc/hopper.cuh``):
  flash-attention forward (causal, sliding window, GQA, optional
  logsumexp); three paths picked by ``flash_schedule`` (wgmma / TMA for
  bf16 and f16 at D 64 and 128, mma.sync for other 16-bit shapes, the CUDA
  cores for f32).
- K7 :mod:`.flash_bwd` (``csrc/flash_bwd.cu``, ``csrc/hopper.cuh``):
  flash-attention backward (dq, dk, dv from the saved output and
  logsumexp; causal, GQA), on the same three paths.
- K8a-d :mod:`.ring` (``csrc/ring.cu``): ring all-gather, ring
  reduce-scatter, both-direction ring all-gather, loopback copy, over
  per-rank shards on one card or one card per rank.
- K9 and K10 :mod:`.coalesce` (``csrc/coalesce.cu``): the coalesced-fetch
  experiment's k-row bulk-copy fetch and its block-coalesced embedding bag.

Each wrapper adds one to ``launch_counts[<kernel>]`` where it launches its
CUDA kernel and nowhere else, so a run can show which kernels its path went
through; kernels with several paths (or routes) also count
``<kernel>_<path>``.
Importing this package builds nothing; it registers K1, K2, the dedup and
the interaction as the PyTorch ops ``param_tpu_torch::emb_gather``,
``param_tpu_torch::sparse_update``, ``param_tpu_torch::dedup_sum`` and
``param_tpu_torch::dot_interaction`` / ``::dot_interaction_bwd`` (a
generated execution-trace replay script imports it for that).
"""

launch_counts = {
    "emb_gather": 0,
    "sparse_update_sgd": 0,
    "sparse_update_adagrad": 0,
    "dedup_sum": 0,
    "dot_interaction": 0,
    "dot_interaction_tiled": 0,
    "dot_interaction_bwd": 0,
    "dot_interaction_bwd_tiled": 0,
    "gemm_f32": 0,
    "gemm_bf16": 0,
    "gemm_f16": 0,
    "gemm_wres": 0,
    "gemm_wgmma": 0,
    "gemm_mma_sync": 0,
    "int4_gemm": 0,
    "int4_gemm_stream": 0,
    "int4_gemm_wgmma": 0,
    "int4_gemm_mma_sync": 0,
    "int4_gemm_simt": 0,
    "flash_fwd": 0,
    "flash_fwd_wgmma": 0,
    "flash_fwd_mma_sync": 0,
    "flash_fwd_tf32x3": 0,
    "flash_bwd": 0,
    "flash_bwd_wgmma": 0,
    "flash_bwd_mma_sync": 0,
    "flash_bwd_tf32x3": 0,
    "ring_all_gather": 0,
    "ring_all_gather_memory": 0,
    "ring_all_gather_copy": 0,
    "ring_reduce_scatter": 0,
    "ring_reduce_scatter_memory": 0,
    "ring_reduce_scatter_cluster": 0,
    "ring_reduce_scatter_copy": 0,
    "ring_bidir_all_gather": 0,
    "ring_bidir_all_gather_memory": 0,
    "ring_bidir_all_gather_copy": 0,
    "ring_loopback": 0,
    "desc_fetch": 0,
    "coalesced_bag": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# registers param_tpu_torch::emb_gather, ::sparse_update, ::dedup_sum,
# ::dot_interaction and ::dot_interaction_bwd
from param_tpu_torch.kernels import emb_gather as _k1  # noqa: E402,F401
from param_tpu_torch.kernels import sparse_update as _k2  # noqa: E402,F401
from param_tpu_torch.kernels import dedup as _dedup  # noqa: E402,F401
from param_tpu_torch.kernels import interaction as _dot  # noqa: E402,F401
