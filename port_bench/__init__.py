"""The port's benchmark: DLRM training on ``param_tpu_torch`` (see README.md)."""
