"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

- K1 :mod:`.emb_gather` (``csrc/emb_gather.cu``): sum-pooled embedding bag.
- K2 :mod:`.sparse_update` (``csrc/sparse_update.cu``): in-place SGD /
  Adagrad row update.

Each wrapper adds one to ``launch_counts[<kernel>]`` where it launches its
CUDA kernel and nowhere else, so a run can show which kernels its path went
through.  Importing this package builds nothing.
"""

launch_counts = {
    "emb_gather": 0,
    "sparse_update_sgd": 0,
    "sparse_update_adagrad": 0,
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
