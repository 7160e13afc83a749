"""Models of the port: DLRM (single device and table-wise sharded), its
data and comm bench, the transformer block (serving, training, dp x tp and
pipeline steps), the expert-parallel MoE layer, the differentiable
collectives they share, and parameter conversion from the reference
package's layout."""

from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel  # noqa: F401
