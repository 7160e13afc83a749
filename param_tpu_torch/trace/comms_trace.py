"""Comm-trace data model and parsers (the port's
``param_tpu/trace/comms_trace.py``; PARAM's ``commsArgs`` and
``commsTraceParser``).

The on-disk "basic" JSON schema is byte-compatible with the reference's
(PARAM's ``_parseBasicTrace`` field names), so a trace written by either
package replays on both; ``cli.comms --trace-dump`` and ``cli.dlrm
--print-comms`` write it.  The JAX package's own jaxpr execution trace
(``trace_type="et"``) is not read here.
"""

from __future__ import annotations

import gzip
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

# name aliasing (reference: paramToCommName, comms_utils.py:446-485)
_ALIASES = {
    "alltoall": "all_to_all",
    "alltoallv": "all_to_allv",
    "alltoallsingle": "all_to_all_single",
    "alltoallbase": "all_to_allv",
    "allreduce": "all_reduce",
    "allgather": "all_gather",
    "allgatherbase": "all_gather_base",
    "allgatherintotensor": "all_gather_base",
    "reducescatter": "reduce_scatter",
    "reducescatterbase": "reduce_scatter_base",
    "reducescattertensor": "reduce_scatter_base",
    "sendrecv": "pt2pt",
    "recvanysource": "recv",
    # coalesced variants map to their dense equivalents (reference handles
    # them via flattened splits, et_replay/comm/commsTraceParser.py:218-226)
    "allreducecoalesced": "all_reduce",
    "allgatherintotensorcoalesced": "all_gather_base",
    "reducescattertensorcoalesced": "reduce_scatter_base",
}

SKIP_OPS = {"wait", "barrier", "init", "batch_isend_irecv"}
P2P_OPS = {"send", "recv", "isend", "irecv"}


def to_comm_name(name: str) -> str:
    """Normalize a collective name (strip separators, resolve aliases)."""
    clean = re.sub(r"[-_\s]", "", name.lower())
    if clean in _ALIASES:
        return _ALIASES[clean]
    # names already in canonical form pass through
    return name.lower()


@dataclass
class CommsOp:
    """One replayable trace element (reference: commsArgs,
    comms_utils.py:551-660)."""

    id: int = 0
    comms: Optional[str] = None
    compute: Optional[str] = None
    in_msg_size: int = 0  # elements, not bytes (reference convention)
    out_msg_size: int = 0
    dtype: str = "float32"
    in_split: Optional[List[int]] = None
    out_split: Optional[List[int]] = None
    root: int = 0
    src_rank: int = 0
    dst_rank: int = 0
    pg_id: Optional[int] = None
    group_ranks: Optional[List[int]] = None
    world_size: Optional[int] = None
    req: Optional[int] = None
    start_time_ns: Optional[int] = None
    markers: List[str] = field(default_factory=list)
    # compute-op fields (gemm / emb_lookup)
    count: int = 1
    mm_dims: Optional[List[int]] = None  # [m, k, k, n]
    emb_dim: int = 0
    num_embs: int = 0
    batch_size: int = 0
    bag_size: int = 0

    def signature(self):
        """Tensor-prep cache key (reference: hashEtCommsOp,
        commsTraceReplay.py:571)."""
        return (
            self.comms, self.compute, self.in_msg_size, self.out_msg_size,
            self.dtype, tuple(self.in_split or ()), tuple(self.out_split or ()),
            self.root, self.pg_id,
            tuple(self.mm_dims or ()), self.emb_dim, self.num_embs,
            self.batch_size, self.bag_size,
        )


def _parse_basic_op(cnt: int, cur: Dict[str, Any]) -> CommsOp:
    op = CommsOp(id=cnt, markers=cur.get("markers") or [])
    if "comms" in cur:
        op.comms = to_comm_name(cur["comms"])
        if not op.markers:
            op.markers = [op.comms]
        op.req = cur.get("req")
        op.start_time_ns = cur.get("startTime_ns")
        op.world_size = cur.get("world_size")
        op.root = cur.get("root") or 0
        op.pg_id = cur.get("pg_id")
        op.group_ranks = cur.get("global_ranks")
        if op.comms not in SKIP_OPS:
            op.in_msg_size = cur["in_msg_size"]
            op.out_msg_size = cur["out_msg_size"]
            op.dtype = cur["dtype"].lower()
        if op.comms == "all_to_allv":
            op.in_split = cur.get("in_split")
            op.out_split = cur.get("out_split")
        if op.comms in P2P_OPS or op.comms == "pt2pt":
            op.src_rank = cur.get("src_rank", 0)
            op.dst_rank = cur.get("dst_rank", 0)
    elif "compute" in cur:
        op.compute = cur["compute"].lower()
        if not op.markers:
            op.markers = [op.compute]
        op.count = cur.get("count", 1)
        if op.compute == "gemm":
            if "mm_dim" in cur:
                d = cur["mm_dim"]
                op.mm_dims = [d, d, d, d]
            else:
                op.mm_dims = [
                    cur.get("mm0_dim0", 0), cur.get("mm0_dim1", 0),
                    cur.get("mm1_dim0", 0), cur.get("mm1_dim1", 0),
                ]
            op.dtype = (cur.get("dtype") or "float32").lower()
        elif op.compute == "emb_lookup":
            op.emb_dim = cur.get("emb_dim", 0)
            op.num_embs = cur.get("num_embs", 0)
            op.batch_size = cur.get("batch_size", 0)
            op.bag_size = cur.get("bag_size", 0)
        else:
            raise ValueError(f"unsupported compute element {op.compute!r}")
    else:
        raise ValueError(
            "trace element has neither 'comms' nor 'compute' "
            f"(element {cnt}: keys {sorted(cur)})"
        )
    return op


VALID_TRACE_TYPES = ("basic", "pytorch_et", "kineto")


def parse_trace(
    in_trace,
    trace_type: str = "basic",
    target_rank: int = 0,
    total_ranks: int = 0,
) -> List[CommsOp]:
    """Trace elements -> :class:`CommsOp` list (PARAM's ``parseTrace``);
    trace types ``basic`` | ``pytorch_et`` | ``kineto``."""
    if trace_type == "basic":
        return [_parse_basic_op(i, cur) for i, cur in enumerate(in_trace)]
    if trace_type == "pytorch_et":
        from param_tpu_torch.trace.pytorch_et import comms_from_pytorch_et

        return comms_from_pytorch_et(in_trace, target_rank, total_ranks)
    if trace_type == "kineto":
        from param_tpu_torch.trace.pytorch_et import comms_from_kineto

        return comms_from_kineto(in_trace, target_rank)
    raise ValueError(
        f"unrecognized trace format {trace_type!r}; valid: {VALID_TRACE_TYPES}"
    )


def read_trace_file(path: str) -> List[dict]:
    """Load a (optionally gzipped) JSON trace file
    (reference: et_replay utils.py:30-75)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def dump_trace_file(ops: Sequence[dict], path: str) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(list(ops), f, indent=2)

