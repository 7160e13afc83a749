"""The trace tier: the comm-trace data model and parsers (basic, PyTorch
ET, Kineto, and an execution trace's collectives), the PyTorch-ET
exporter, the comm replay engine, its bandwidth analysis and the reader of
``torch.profiler`` chrome traces; the execution trace of an aten graph
(:mod:`.execution_trace`), its capture (:mod:`.capture`) and its op-by-op
replay and code generator (:mod:`.et_replay`); the op-level compute replay
of a recorded PyTorch ET (:mod:`.pytorch_op_replay`) with its attention
fusion (:mod:`.attention_fusion`); and the analytic scaling model
(:mod:`.scaling_model`)."""

from param_tpu_torch.trace.attention_fusion import (  # noqa: F401
    AttnBwdWindow,
    AttnWindow,
    find_attention_bwd_windows,
    find_attention_windows,
)
from param_tpu_torch.trace.comms_trace import (  # noqa: F401
    CommsOp,
    parse_trace,
    to_comm_name,
)
from param_tpu_torch.trace.pytorch_op_replay import (  # noqa: F401
    PyTorchOpReplay,
    UnsupportedOp,
    supported_aten_ops,
)
from param_tpu_torch.trace.replay import (  # noqa: F401
    CommsReplay,
    ReplayParams,
)
from param_tpu_torch.trace.scaling_model import (  # noqa: F401
    format_report,
    predict_collective_us,
    predict_trace,
    predict_worlds,
    slice_topology,
)
