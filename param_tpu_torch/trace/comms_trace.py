"""Comm-trace data model and parsers (the port's
``param_tpu/trace/comms_trace.py``; PARAM's ``commsArgs`` and
``commsTraceParser``).

The on-disk "basic" JSON schema is byte-compatible with the reference's
(PARAM's ``_parseBasicTrace`` field names), so a trace written by either
package replays on both; ``cli.comms --trace-dump`` and ``cli.dlrm
--print-comms`` write it.  An execution trace (``trace_type="et"``: the
port's aten graph or the JAX package's jaxpr) gives its collective stream
through :func:`comms_from_et`.
"""

from __future__ import annotations

import gzip
import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch.distributed as dist

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
        commsTraceReplay.py:571).  A pt2pt op's key holds its pair: the
        cached arguments carry the ranks, so two equal-sized sends between
        different pairs must not share them."""
        key = (
            self.comms, self.compute, self.in_msg_size, self.out_msg_size,
            self.dtype, tuple(self.in_split or ()), tuple(self.out_split or ()),
            self.root, self.pg_id,
            tuple(self.mm_dims or ()), self.emb_dim, self.num_embs,
            self.batch_size, self.bag_size,
        )
        if self.comms == "pt2pt" or self.comms in P2P_OPS:
            key += (self.src_rank, self.dst_rank)
        return key


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



# the JAX package's collective primitives (param_tpu/trace/comms_trace.py
# comms_from_et)
_JAX_COMMS = {
    "psum": "all_reduce",
    "all_reduce": "all_reduce",
    "pmax": "all_reduce",
    "pmin": "all_reduce",
    "all_gather": "all_gather",
    "psum_scatter": "reduce_scatter",
    "reduce_scatter": "reduce_scatter",
    "all_to_all": "all_to_all",
    "ragged_all_to_all": "all_to_allv",
    "ppermute": "pt2pt",
    "collective_permute": "pt2pt",
}

# The c10d nodes' replay calls.  Each takes the node's positional arguments
# (tensors resolved, the group a live process group, the reduce op a
# dist.ReduceOp), issues the torch.distributed call that records that op,
# waits for it, and returns what the op returns besides its Work.  The
# execution-trace code generator copies them into its scripts.
def _c10d_allreduce(tensors, group, op, *rest):
    for t in tensors:
        dist.all_reduce(t, op=op, group=group)
    return tensors


def _c10d_allreduce_coalesced(tensors, group, op, *rest):
    dist.all_reduce_coalesced(list(tensors), op=op, group=group)


def _c10d_alltoall_base(output, input, group, out_splits=(), in_splits=(),
                        *rest):
    dist.all_to_all_single(output, input, list(out_splits) or None,
                           list(in_splits) or None, group=group)


def _c10d_alltoall(outputs, inputs, group, *rest):
    dist.all_to_all(list(outputs), list(inputs), group=group)
    return outputs


def _c10d_allgather(output_lists, inputs, group, *rest):
    for outs, i in zip(output_lists, inputs):
        dist.all_gather(list(outs), i, group=group)
    return output_lists


def _c10d_allgather_base(output, input, group, *rest):
    dist.all_gather_into_tensor(output, input, group=group)
    return output


def _c10d_allgather_coalesced(outputs, inputs, group, *rest):
    for o, i in zip(outputs, inputs):
        dist.all_gather_into_tensor(o, i, group=group)


def _c10d_reduce_scatter(outputs, input_lists, group, op, *rest):
    for o, ins in zip(outputs, input_lists):
        dist.reduce_scatter(o, list(ins), op=op, group=group)
    return outputs


def _c10d_reduce_scatter_base(output, input, group, op, *rest):
    dist.reduce_scatter_tensor(output, input, op=op, group=group)
    return output


def _c10d_reduce_scatter_coalesced(outputs, inputs, group, op, *rest):
    for o, i in zip(outputs, inputs):
        dist.reduce_scatter_tensor(o, i, op=op, group=group)


def _c10d_broadcast(tensors, group, root, *rest):
    for t in tensors:
        dist.broadcast(t, dist.get_global_rank(group, root), group=group)
    return tensors


def _c10d_send(tensors, group, dst, tag=0, *rest):
    for t in tensors:
        dist.send(t, dist.get_global_rank(group, dst), group=group, tag=tag)


def _c10d_recv(tensors, group, src, tag=0, *rest):
    for t in tensors:
        dist.recv(t, dist.get_global_rank(group, src), group=group, tag=tag)


def _c10d_barrier(tensor, group, *rest):
    dist.barrier(group=group)


class TorchComm(NamedTuple):
    """How a collective node of a captured aten graph is read and replayed:
    its comm name, the positions of its input and output tensor arguments
    (``out_pos`` None: the op's own return), and the call that replays a
    c10d op (None for a functional collective, which replays as itself on
    the live group's name)."""

    comms: str
    in_pos: int
    out_pos: Optional[int]
    replay: Optional[Callable] = None


# c10d / functional-collective ops of a captured aten graph, by op without
# its overload.  A c10d op missing here is neither counted nor replayed.
TORCH_COMMS = {
    "c10d::allreduce_": TorchComm("all_reduce", 0, 0, _c10d_allreduce),
    "c10d::allreduce_coalesced_": TorchComm(
        "all_reduce", 0, 0, _c10d_allreduce_coalesced),
    "c10d::alltoall_base_": TorchComm(
        "all_to_all", 1, 0, _c10d_alltoall_base),
    "c10d::alltoall_": TorchComm("all_to_all", 1, 0, _c10d_alltoall),
    "c10d::_allgather_base_": TorchComm(
        "all_gather", 1, 0, _c10d_allgather_base),
    "c10d::allgather_": TorchComm("all_gather", 1, 0, _c10d_allgather),
    "c10d::allgather_into_tensor_coalesced": TorchComm(
        "all_gather", 1, 0, _c10d_allgather_coalesced),
    "c10d::_reduce_scatter_base_": TorchComm(
        "reduce_scatter", 1, 0, _c10d_reduce_scatter_base),
    "c10d::reduce_scatter_": TorchComm(
        "reduce_scatter", 1, 0, _c10d_reduce_scatter),
    "c10d::reduce_scatter_tensor_coalesced": TorchComm(
        "reduce_scatter", 1, 0, _c10d_reduce_scatter_coalesced),
    "c10d::broadcast_": TorchComm("broadcast", 0, 0, _c10d_broadcast),
    "c10d::send": TorchComm("pt2pt", 0, 0, _c10d_send),
    "c10d::recv_": TorchComm("pt2pt", 0, 0, _c10d_recv),
    "c10d::barrier": TorchComm("barrier", 0, 0, _c10d_barrier),
    "_c10d_functional::all_reduce": TorchComm("all_reduce", 0, None),
    "_c10d_functional::all_reduce_": TorchComm("all_reduce", 0, 0),
    "_c10d_functional::all_to_all_single": TorchComm("all_to_all", 0, None),
    "_c10d_functional::all_gather_into_tensor": TorchComm(
        "all_gather", 0, None),
    "_c10d_functional::reduce_scatter_tensor": TorchComm(
        "reduce_scatter", 0, None),
    "_c10d_functional::broadcast": TorchComm("broadcast", 0, None),
}


def op_base(name: str) -> str:
    """``ns::op.overload`` -> ``ns::op`` (a JAX primitive name unchanged)."""
    return name.rsplit(".", 1)[0] if "::" in name else name


def _tids(v) -> List[int]:
    """The tensor ids in an encoded argument (a ``{"__tensor__": tid}``
    reference, or nested lists of them), in order."""
    if isinstance(v, dict) and "__tensor__" in v:
        return [v["__tensor__"]]
    if isinstance(v, list):
        return [t for x in v for t in _tids(x)]
    return []


def _torch_comm(et, n) -> "CommsOp":
    """One c10d node of a captured aten graph as a :class:`CommsOp`; a
    size counts every tensor of the argument (a list op's whole list)."""
    comms, in_pos, out_pos, _ = TORCH_COMMS[op_base(n.name)]
    args = n.params.get("args", [])

    def elems(tids):
        ts = [et.tensors[t] for t in tids if t in et.tensors]
        return sum(int(np.prod(t.shape)) for t in ts), ts

    in_elems, tin = elems(_tids(args[in_pos]) if in_pos < len(args) else [])
    out_elems, _ = elems(_tids(args[out_pos]) if out_pos is not None
                         and out_pos < len(args) else n.outputs[:1])
    in_elems = in_elems or 1
    out_elems = out_elems or in_elems
    tin = tin[0] if tin else None
    group = next((a["__group__"] for a in args
                  if isinstance(a, dict) and "__group__" in a), {})
    op = CommsOp(id=n.id, comms=comms, in_msg_size=in_elems,
                 out_msg_size=out_elems,
                 dtype=(tin.dtype if tin else "float32"),
                 world_size=group.get("size"), markers=[n.name],
                 group_ranks=group.get("ranks"))
    base = op_base(n.name)
    if base == "c10d::alltoall_base_" and len(args) > 4 and (
            args[3] or args[4]):
        op.comms, op.out_split, op.in_split = "all_to_allv", list(args[3]), \
            list(args[4])
    if comms == "pt2pt":
        ranks = group.get("ranks") or []
        me = group.get("rank", 0)
        peer = int(args[2]) if len(args) > 2 else 0
        peer = ranks[peer] if peer < len(ranks) else peer
        op.src_rank, op.dst_rank = ((me, peer) if base == "c10d::send"
                                    else (peer, me))
    return op


def comms_from_et(et, world_size: int) -> List[CommsOp]:
    """The collective stream of an execution trace as replayable comm ops
    (PARAM's ``commsTraceParser._parseExecutionTrace``).

    A JAX-package trace (``param-tpu-et-1.0``) gives its collective
    primitives, those inside shard_map scopes included, exactly as
    ``param_tpu.trace.comms_trace.comms_from_et`` does.  A trace the port
    captured gives its c10d nodes (:data:`TORCH_COMMS`): sizes are this
    rank's element counts, the world the recorded group's (``world_size``
    when none was recorded)."""
    from param_tpu_torch.trace.execution_trace import JAX_SCHEMA

    out: List[CommsOp] = []
    nodes = sorted(et.nodes.values(), key=lambda n: n.id)
    if et.schema != JAX_SCHEMA:
        for n in nodes:
            if n.op and op_base(n.name) in TORCH_COMMS:
                op = _torch_comm(et, n)
                op.world_size = op.world_size or world_size
                out.append(op)
        return out
    for n in nodes:
        if n.name not in _JAX_COMMS:
            continue
        tin = next((et.tensors[t] for t in n.inputs
                    if t is not None and t in et.tensors), None)
        tout = next((et.tensors[t] for t in n.outputs
                     if t is not None and t in et.tensors), None)
        in_elems = int(np.prod(tin.shape)) if tin and tin.shape else 1
        out_elems = int(np.prod(tout.shape)) if tout and tout.shape else in_elems
        op = CommsOp(
            id=n.id,
            comms=_JAX_COMMS.get(n.name, n.name),
            in_msg_size=in_elems,
            out_msg_size=out_elems,
            dtype=(tin.dtype if tin else "float32"),
            world_size=world_size,
            markers=[n.name],
        )
        if op.comms == "pt2pt":
            perm = n.params.get("perm") or n.params.get("permutation")
            if isinstance(perm, dict):
                perm = None
            if perm:
                first = perm[0]
                pair = first.get("__tuple__", first) if isinstance(first, dict) else first
                if isinstance(pair, (list, tuple)) and len(pair) == 2:
                    op.src_rank, op.dst_rank = int(pair[0]), int(pair[1])
        out.append(op)
    return out
