"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

- K1 :mod:`.emb_gather` (``csrc/emb_gather.cu``): sum-pooled embedding bag.
- K2 :mod:`.sparse_update` (``csrc/sparse_update.cu``): in-place SGD /
  Adagrad row update.
- K3 and K4 :mod:`.gemm` (``csrc/gemm.cu``): tiled GEMM; stacked GEMMs
  sharing one weight.
- K5 :mod:`.int4_gemm` (``csrc/int4_gemm.cu``): x @ group-int4 weights.

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
    "int4_gemm": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
