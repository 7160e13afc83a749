"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

- K1 :mod:`.emb_gather` (``csrc/emb_gather.cu``): sum-pooled embedding bag.
- K2 :mod:`.sparse_update` (``csrc/sparse_update.cu``): in-place SGD /
  Adagrad row update.
- K3 and K4 :mod:`.gemm` (``csrc/gemm.cu``, ``csrc/hopper.cuh``): tiled
  GEMM (wgmma / TMA for bf16 and f16, mma.sync where TMA cannot read the
  rows, an FMA core for f32; split K for small grids); stacked GEMMs
  sharing one weight.
- K5 :mod:`.int4_gemm` (``csrc/int4_gemm.cu``): x @ group-int4 weights.
- K6 :mod:`.flash_fwd` (``csrc/flash_fwd.cu``): flash-attention forward
  (causal, sliding window, GQA, optional logsumexp).
- K7 :mod:`.flash_bwd` (``csrc/flash_bwd.cu``): flash-attention backward
  (dq, dk, dv from the saved output and logsumexp; causal, GQA).
- K8a-d :mod:`.ring` (``csrc/ring.cu``): ring all-gather, ring
  reduce-scatter, both-direction ring all-gather, loopback copy, over
  per-rank shards on one card or one card per rank.
- K9 and K10 :mod:`.coalesce` (``csrc/coalesce.cu``): the coalesced-fetch
  experiment's k-row bulk-copy fetch and its block-coalesced embedding bag.

Each wrapper adds one to ``launch_counts[<kernel>]`` where it launches its
CUDA kernel and nowhere else, so a run can show which kernels its path went
through.  Importing this package builds nothing.
"""

launch_counts = {
    "emb_gather": 0,
    "sparse_update_sgd": 0,
    "sparse_update_adagrad": 0,
    "gemm_f32": 0,
    "gemm_bf16": 0,
    "gemm_f16": 0,
    "gemm_wres": 0,
    "gemm_wgmma": 0,
    "gemm_mma_sync": 0,
    "int4_gemm": 0,
    "flash_fwd": 0,
    "flash_bwd": 0,
    "ring_all_gather": 0,
    "ring_reduce_scatter": 0,
    "ring_bidir_all_gather": 0,
    "ring_loopback": 0,
    "desc_fetch": 0,
    "coalesced_bag": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
