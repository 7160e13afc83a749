"""The collective sweep benchmark: tensor prep and validation
(:mod:`.harness`) and the nccl-tests-style sweep (:mod:`.coll_bench`)."""

from param_tpu_torch.comms.harness import (  # noqa: F401
    CommsBench,
    CommsParams,
    TimingMode,
)
