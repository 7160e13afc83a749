"""The trace tier: the comm-trace data model and parsers (basic, PyTorch
ET, Kineto, and an execution trace's collectives), the PyTorch-ET
exporter, the comm replay engine, its bandwidth analysis and the reader of
``torch.profiler`` chrome traces; the execution trace of an aten graph
(:mod:`.execution_trace`), its capture (:mod:`.capture`) and its op-by-op
replay and code generator (:mod:`.et_replay`)."""

from param_tpu_torch.trace.comms_trace import (  # noqa: F401
    CommsOp,
    parse_trace,
    to_comm_name,
)
from param_tpu_torch.trace.replay import (  # noqa: F401
    CommsReplay,
    ReplayParams,
)
