"""PyTorch/CUDA port of param_tpu for one NVIDIA H100.

The JAX package ``param_tpu`` is the reference; this package keeps its public
names and layouts so each function has an obvious counterpart.  Importing it
builds no kernel and touches no device: kernels are compiled at first use
(:mod:`param_tpu_torch.kernels.build`).
"""

__version__ = "0.1.0"
