"""PyTorch execution-trace (Chakra host ET) comm-stream ingestion (the
port's ``param_tpu/trace/pytorch_et.py``).

Parses the PyTorch ET JSON schema (the traces
``torch.profiler.ExecutionTraceObserver`` writes) and the Kineto unitrace,
and extracts the communication stream as replayable :class:`CommsOp`
elements.

Reference parity:
- legacy parser (schema < 1.0.3): ``train/comms/pt/commsTraceParser.py:214-339``
  (``_parseExecutionTrace``), sizes from input/output tensor metadata;
- modern parser (schema >= 1.0.3): ``et_replay/comm/commsTraceParser.py:64-266``
  (``_parse_comms_op_node``), sizes/pg from the ``record_param_comms`` node's
  comm attrs (``execution_trace.py:98-113`` ``_CommArgs``);
- PG-init extraction: ``_parse_proc_group_info``
  (``et_replay/comm/commsTraceParser.py:87-124``).

Design difference from PARAM's parser: instead of its
fixed-index ``shift`` arithmetic into ``node.inputs`` (which mis-indexes
nodes whose input count is neither 8 nor 10 — e.g. 7-input ``all_to_allv``
records in the 1.0.1 DLRM traces), the collective name is located by
scanning for the string input that resolves to a known collective, and the
surrounding fields are read relative to it.  One reader handles every schema
from 1.0.1 to 1.1.1.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from param_tpu_torch.trace.comms_trace import CommsOp, P2P_OPS, to_comm_name

log = logging.getLogger(__name__)

# torch trace dtype token -> dtype name (reference: tensorDtypeMap,
# commsTraceParser.py:11-24; modern traces use capitalized names)
_TORCH_DTYPES = {
    "float": "float32",
    "float32": "float32",
    "double": "float64",
    "half": "float16",
    "c10::half": "float16",
    "bfloat16": "bfloat16",
    "c10::bfloat16": "bfloat16",
    "int": "int32",
    "long": "int64",
    "long int": "int64",
    "bool": "bool",
    "byte": "byte",
    "unsigned char": "byte",
    "signed char": "char",
    "char": "char",
}

# names the comm stream recognizes (after aliasing); anything else in a
# record_param_comms node is reported and skipped
_KNOWN_COMMS = {
    "all_reduce", "reduce", "all_gather", "all_gather_base", "all_gather_v",
    "broadcast", "reduce_scatter", "reduce_scatter_base", "reduce_scatter_v",
    "all_to_all", "all_to_all_single", "all_to_allv", "gather", "scatter",
    "send", "recv", "isend", "irecv", "pt2pt",
    "wait", "barrier", "init",
}

_ROOTED = ("reduce", "broadcast", "gather", "scatter")


def _torch_dtype(token: str) -> str:
    t = token.strip().lower()
    if t.startswith("tensor(") and t.endswith(")"):
        t = t[len("tensor("):-1]
    return _TORCH_DTYPES.get(t, t or "float32")


def is_tensor_slot(type_token: str) -> bool:
    """A slot holding one tensor (not a list of them)."""
    t = type_token or ""
    return "Tensor" in t and "GenericList" not in t


def is_tensor_list_slot(type_token: str) -> bool:
    """A ``GenericList[...]`` slot holding tensors; index lists can lead
    with None slots (``GenericList[None,Tensor(long)]``)."""
    t = type_token or ""
    return t.startswith("GenericList[") and "Tensor" in t


def tensor_key(desc: Any) -> Optional[Tuple[int, int]]:
    """(tensor_id, storage_id) of a tensor descriptor; None for anything
    else."""
    if not isinstance(desc, (list, tuple)) or len(desc) < 4:
        return None
    return (int(desc[0]), int(desc[1]))


@dataclass
class PtNode:
    """One PyTorch-ET node, schema-normalized."""

    id: int
    name: str
    parent: int
    inputs: List[Any]
    input_types: List[str]
    input_shapes: List[Any]
    outputs: List[Any]
    output_types: List[str]
    output_shapes: List[Any]
    comm_attrs: Dict[str, Any] = field(default_factory=dict)
    op_schema: str = ""
    kernel_backend: str = ""

    def is_operator(self) -> bool:
        """Reference NodeType.OPERATOR (execution_trace.py:278-291): a node
        with a recorded ATen schema, a PT2 triton kernel, or a comm
        record."""
        return (
            self.name == "record_param_comms"
            or (self.op_schema != "" and not self.name.startswith("c10d::"))
            or self.kernel_backend == "triton"
        )


class PyTorchETrace:
    """Schema-spanning reader for the PyTorch ET JSON container
    (reference: et_replay/execution_trace.py:360-377 version dispatch —
    here one normalizer; nested inputs dicts appeared in 1.0.2)."""

    COMM_ATTR_NAMES = {
        "collective_name", "dtype", "in_msg_nelems", "out_msg_nelems",
        "in_split_size", "out_split_size", "global_rank_start",
        "global_rank_stride", "pg_name", "pg_desc", "pg_size",
    }

    def __init__(self, data: Dict[str, Any]):
        if not isinstance(data, dict) or "nodes" not in data:
            raise ValueError("not a PyTorch ET: missing 'nodes'")
        self.schema: str = data.get("schema", "1.0.1")
        self.nodes: List[PtNode] = [self._norm(x) for x in data["nodes"]]
        self.by_id = {n.id: n for n in self.nodes}

    def schema_pytorch(self) -> tuple:
        return tuple(int(p) for p in self.schema.split("-")[0].split("."))

    def _norm(self, x: Dict[str, Any]) -> PtNode:
        if isinstance(x.get("inputs"), dict):  # >= 1.0.2-chakra
            ins, outs = x["inputs"], x["outputs"]
            inputs, in_t, in_s = ins["values"], ins["types"], ins["shapes"]
            outputs, out_t, out_s = outs["values"], outs["types"], outs["shapes"]
        else:  # 1.0.1 flat
            inputs, in_t, in_s = (
                x.get("inputs", []), x.get("input_types", []),
                x.get("input_shapes", []),
            )
            outputs, out_t, out_s = (
                x.get("outputs", []), x.get("output_types", []),
                x.get("output_shapes", []),
            )
        comm_attrs = {}
        op_schema = x.get("op_schema", "")  # 1.0.1 flat field
        kernel_backend = x.get("kernel_backend", "")
        for attr in x.get("attrs", []):
            if attr.get("name") in self.COMM_ATTR_NAMES:
                comm_attrs[attr["name"]] = attr.get("value")
            elif attr.get("name") == "op_schema":  # >= 1.0.2 attr
                op_schema = attr.get("value", "")
            elif attr.get("name") == "kernel_backend":
                kernel_backend = attr.get("value", "")
        return PtNode(
            id=x["id"], name=x.get("name", ""),
            parent=x.get("ctrl_deps", x.get("parent", 0)),
            inputs=inputs, input_types=in_t, input_shapes=in_s,
            outputs=outputs, output_types=out_t, output_shapes=out_s,
            comm_attrs=comm_attrs, op_schema=op_schema,
            kernel_backend=kernel_backend,
        )


def _tensor_nelems(values: List[Any], types: List[str]) -> tuple:
    """Total element count + dtype of the tensor argument(s) of a
    record_param_comms node (reference: _getTensorInfoFromPyTorchETEntry,
    commsTraceParser.py:187-212).  Tensor tuples are
    [id, storage, offset, nelem, elem_bytes, device]; they may appear bare,
    in a GenericList, or a GenericList[GenericList[...]]."""
    for v, t in zip(values, types):
        if "Tensor" not in (t or ""):
            continue
        depth = (t or "").count("GenericList")
        tensors = v
        if depth == 2:
            tensors = v[0]
        elif depth == 0:
            tensors = [v]
        total = 0
        for ten in tensors:
            if isinstance(ten, (list, tuple)) and len(ten) >= 4:
                total += int(ten[3])
        dtype = _torch_dtype(
            t.replace("GenericList[", "").replace("]", "").split(",")[0]
        )
        return total, dtype
    return 0, "float32"


def _parse_pg_info(et: PyTorchETrace) -> Dict[int, List[int]]:
    """{pg_id: global ranks} from the process_group:init node
    (reference: _parse_proc_group_info) plus the legacy backend-id map."""
    pg_ranks: Dict[int, List[int]] = {}
    backend_to_pg: Dict[int, int] = {}
    for node in et.nodes:
        if "process_group:init" not in node.name:
            continue
        try:
            pg_objs = json.loads(node.inputs[0])
        except (json.JSONDecodeError, IndexError, TypeError):
            break  # truncated pg_config_info
        for pg in pg_objs:
            if not str(pg.get("pg_name", "")).isdecimal():
                continue  # local-sync pgs unsupported (reference parity)
            pg_id = int(pg["pg_name"])
            ranks = pg.get("ranks") or list(range(pg.get("group_size", 0)))
            pg_ranks[pg_id] = ranks
            backend_id = pg.get("uid", pg.get("backend_id"))
            if backend_id is not None:
                backend_to_pg[backend_id] = pg_id
        break  # only one init node per trace
    pg_ranks["_backend_map"] = backend_to_pg  # type: ignore[index]
    return pg_ranks


def _find_comm_name_idx(node: PtNode) -> Optional[int]:
    """Index of the collective-name string in node.inputs."""
    for i, (v, t) in enumerate(zip(node.inputs, node.input_types)):
        if t == "String" and isinstance(v, str):
            name = to_comm_name(v)
            if name in _KNOWN_COMMS:
                return i
    return None


def comms_from_pytorch_et(
    data: Dict[str, Any], target_rank: int = 0, total_ranks: int = 0
) -> List[CommsOp]:
    """PyTorch ET JSON -> replayable comm op list (+ leading pg init ops).

    Handles schemas 1.0.1 through 1.1.1: comm attrs are preferred when
    present (>= 1.0.3 traces), otherwise sizes/splits come from the node's
    input/output metadata (legacy path).
    """
    et = PyTorchETrace(data)
    pg_map = _parse_pg_info(et)
    backend_map: Dict[int, int] = pg_map.pop("_backend_map", {})  # type: ignore[arg-type]

    ops: List[CommsOp] = []
    # pg init ops first so replay creates the communicators up front
    # (reference: create_pg_init_node prepended, commsTraceParser.py:339-358)
    for pg_id, ranks in sorted(pg_map.items()):
        ops.append(
            CommsOp(
                id=len(ops), comms="init", pg_id=pg_id,
                group_ranks=list(ranks), world_size=len(ranks),
                markers=["init"],
            )
        )

    for node in et.nodes:
        if node.name != "record_param_comms":
            continue
        op = CommsOp(id=node.id, markers=["record_param_comms"])
        ca = node.comm_attrs
        name_idx = _find_comm_name_idx(node)

        if ca.get("collective_name"):
            op.comms = to_comm_name(ca["collective_name"])
        elif name_idx is not None:
            op.comms = to_comm_name(node.inputs[name_idx])
        else:
            log.warning("record_param_comms node %d: no collective name; "
                        "skipped", node.id)
            continue
        if op.comms == "init":
            continue  # init ops already built from pg info

        # req id (field immediately after the tensor block / 3 before name)
        if name_idx is not None and name_idx >= 3:
            req = node.inputs[name_idx - 3]
            op.req = req if isinstance(req, int) else None

        # process group
        pg_id: Optional[int] = None
        if str(ca.get("pg_name", "")).isdecimal():
            pg_id = int(ca["pg_name"])
        elif name_idx is not None and name_idx >= 2:
            ident = node.inputs[name_idx - 2]
            if isinstance(ident, (list, tuple)) and ident and str(ident[0]).isdecimal():
                pg_id = int(ident[0])  # >=1.0.3 (pg_name, pg_desc) tuple
            elif isinstance(ident, int) and ident in backend_map:
                pg_id = backend_map[ident]  # <1.0.3 backend id
        if pg_id is not None and pg_id in pg_map:
            op.pg_id = pg_id
            op.group_ranks = list(pg_map[pg_id])
            op.world_size = len(op.group_ranks)
        if not op.world_size:
            op.world_size = total_ranks or None

        if op.comms in ("wait", "barrier"):
            ops.append(op)
            continue

        # message sizes: comm attrs when available, tensor metadata otherwise
        if ca.get("in_msg_nelems") is not None:
            op.in_msg_size = int(ca["in_msg_nelems"])
            op.out_msg_size = int(ca.get("out_msg_nelems", op.in_msg_size))
            op.dtype = _torch_dtype(ca.get("dtype", "float"))
        else:
            op.in_msg_size, op.dtype = _tensor_nelems(
                node.inputs, node.input_types
            )
            op.out_msg_size, _ = _tensor_nelems(node.outputs, node.output_types)
            if not op.out_msg_size:
                op.out_msg_size = op.in_msg_size

        # recorded rank: p2p peer (local to the pg) or the root of a rooted
        # collective (reference: et_replay/comm/commsTraceParser.py:200-213)
        recorded_rank = 0
        if name_idx is not None and name_idx >= 1:
            rr = node.inputs[name_idx - 1]
            if isinstance(rr, int):
                recorded_rank = rr
        ranks = op.group_ranks or list(range(op.world_size or 1))

        def to_global(r):
            return ranks[r] if 0 <= r < len(ranks) else r

        if op.comms in P2P_OPS:
            if "send" in op.comms:
                op.src_rank, op.dst_rank = target_rank, to_global(recorded_rank)
            else:
                op.src_rank, op.dst_rank = to_global(recorded_rank), target_rank
        elif op.comms in _ROOTED:
            op.root = to_global(recorded_rank)

        # splits for ragged exchanges
        if op.comms == "all_to_allv":
            in_split = out_split = None
            if ca.get("in_split_size"):
                try:
                    in_split = json.loads(ca["in_split_size"]) or None
                    out_split = json.loads(ca.get("out_split_size", "[]")) or None
                except json.JSONDecodeError:
                    pass
            if in_split is None and name_idx is not None:
                rest = node.inputs[name_idx + 1 : name_idx + 3]
                lists = [v for v in rest if isinstance(v, list)]
                if lists and lists[0]:
                    in_split = lists[0]
                    out_split = lists[1] if len(lists) > 1 and lists[1] else lists[0]
            n = op.world_size or total_ranks or (len(in_split) if in_split else 1)
            op.in_split = in_split or [op.in_msg_size // n] * n
            op.out_split = out_split or [op.out_msg_size // n] * n

        ops.append(op)
    return ops


def comms_from_kineto(
    events: Any, target_rank: int = 0
) -> List[CommsOp]:
    """Kineto unitrace (with comms metadata in ``args``) -> comm op list
    (reference: _parseKinetoUnitrace, commsTraceParser.py:154-184).

    Accepts either a bare event list or a chrome-trace dict with
    ``traceEvents``.  Only ``record_param_comms`` events whose
    ``args.rank == target_rank`` are taken (per-rank trace extraction)."""
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops: List[CommsOp] = []
    for entry in events:
        if entry.get("name") != "record_param_comms":
            continue
        args = entry.get("args", {})
        if "comms" not in args:
            continue  # plain profiler event without comms metadata
        if args.get("rank", target_rank) != target_rank:
            continue
        op = CommsOp(
            id=len(ops),
            comms=to_comm_name(args["comms"]),
            in_msg_size=args.get("in_msg_size", 0),
            out_msg_size=args.get("out_msg_size", 0),
            dtype=_torch_dtype(args.get("dtype", "float")),
            in_split=args.get("in_split") or None,
            out_split=args.get("out_split") or None,
            markers=["kineto"],
        )
        if "ts" in entry:
            op.start_time_ns = int(entry["ts"] * 1e3)  # kineto ts is us
        ops.append(op)
    return ops
