"""The comm-trace tier: trace data model and parsers (basic, PyTorch ET,
Kineto), the PyTorch-ET exporter, the replay engine, its bandwidth
analysis and the reader of ``torch.profiler`` chrome traces."""

from param_tpu_torch.trace.comms_trace import (  # noqa: F401
    CommsOp,
    parse_trace,
    to_comm_name,
)
from param_tpu_torch.trace.replay import (  # noqa: F401
    CommsReplay,
    ReplayParams,
)
