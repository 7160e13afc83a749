"""Mock backend for the harness's control flow (the port's
``param_tpu/backend/mock_backend.py``; PARAM's ``MockBackendFunction``).

Every collective is a no-op that logs ``(name, args)`` in ``calls`` and
returns its input; ``compute_fn`` holds plain CPU ops.  It needs no process
group and no device: tensors stay on the CPU, so ``cli.comms --backend
mock`` and a replay's dry run work anywhere.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from param_tpu_torch.backend.base import (
    SUPPORTED_COLLECTIVES,
    Backend,
    CollectiveArgs,
    CommGroup,
    register_backend,
)


class MockBackend(Backend):
    def __init__(self, world_size: int = 1, rank: int = 0):
        super().__init__()
        self.world_size = world_size
        self.rank = rank
        self._default_group = CommGroup(ranks=list(range(world_size)),
                                        pg_id=0, name="mock")
        self._groups = [self._default_group]
        self.calls: List[tuple] = []  # (collective name, args) per call
        for name in SUPPORTED_COLLECTIVES + ["noop"]:
            self.collective_fn[name] = self._make_mock(name)
        self.compute_fn = {
            "gemm": torch.matmul,
            "add": torch.add,
            "sub": torch.sub,
            "copy": torch.clone,
        }

    def _make_mock(self, name):
        def mock_collective(args: CollectiveArgs):
            self.calls.append((name, args))
            return args.in_tensor

        return mock_collective

    def initialize(self) -> None:
        pass

    def get_local_rank(self) -> int:
        return self.rank

    def get_global_rank(self) -> int:
        return self.rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_device(self):
        return torch.device("cpu")

    def get_default_group(self) -> CommGroup:
        return self._default_group

    def get_groups(self) -> List[CommGroup]:
        return list(self._groups)

    def new_group(self, ranks: Sequence[int], pg_id: int = 0) -> CommGroup:
        g = CommGroup(ranks=list(ranks), pg_id=pg_id, name=f"mock{pg_id}")
        self._groups.append(g)
        return g

    def complete_ops(self) -> None:
        pass

    def barrier(self, group: Optional[CommGroup] = None) -> None:
        pass


register_backend("mock", MockBackend)
