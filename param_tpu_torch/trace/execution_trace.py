"""Execution-trace data model: an op-level graph with tensor dependencies
(the port's ``param_tpu/trace/execution_trace.py``; PARAM's
``et_replay/execution_trace.py``).

A ``Node`` tree (parent / children; op vs label nodes), a ``TensorNode``
producer / consumer graph, schema-versioned JSON, iteration segmentation,
and text / graphviz export.

The port's schema is ``param-tpu-torch-et-1.0``: the layout of the JAX
package's ``param-tpu-et-1.0``, with the framework's own op vocabulary.
Node names are fully qualified op overloads (``aten::mm.default``,
``c10d::alltoall_base_.default``, ``param_tpu_torch::emb_gather.default``)
and params hold the call's arguments (:mod:`.capture`)::

    {"schema": "param-tpu-torch-et-1.0",
     "nodes": [{"id": int, "name": str,            # op overload
                "parent": int,                      # nesting (0 = root)
                "op": bool,                         # leaf op vs label
                "inputs": [tensor_id],              # tensor arguments
                "outputs": [tensor_id],             # results, then
                                                    # arguments it writes
                "params": {"args": [...], "kwargs": {...}},
                "iter": int}],                      # ProfilerStep analogue
     "tensors": {id: {"shape": [...], "dtype": str}},
     "const_tensors": {id: {"v": [...], "dtype": str}},
     "in_tensors": [...], "out_tensors": [...]}

:class:`ExecutionTrace` also reads the JAX package's jaxpr traces (names
are jaxpr primitives there), so ``cli.et validate`` and ``cli.replay
--trace-type et`` take them; only the port's own schema replays op by op
(:mod:`.et_replay`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from param_tpu_torch.trace.comms_trace import TORCH_COMMS, op_base

SCHEMA = "param-tpu-torch-et-1.0"
JAX_SCHEMA = "param-tpu-et-1.0"


@dataclass
class TensorNode:
    """(reference: execution_trace.py TensorNode:73-95)"""

    id: int
    shape: Tuple[int, ...]
    dtype: str
    sources: Set[int] = field(default_factory=set)  # producer node ids
    sinks: Set[int] = field(default_factory=set)  # consumer node ids

    def to_json(self):
        return {"shape": list(self.shape), "dtype": self.dtype}


@dataclass
class Node:
    """(reference: execution_trace.py Node:96-277)"""

    id: int
    name: str
    parent_id: int = 0
    op: bool = True  # False => label/scope node (reference detect_type:278)
    inputs: List[Optional[int]] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)
    params: Dict[str, Any] = field(default_factory=dict)
    iteration: int = 0
    children: List["Node"] = field(default_factory=list)

    def is_comm(self) -> bool:
        return self.name in COMM_PRIMITIVES or op_base(self.name) in \
            COMM_PRIMITIVES

    def to_json(self):
        return {
            "id": self.id,
            "name": self.name,
            "parent": self.parent_id,
            "op": self.op,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "params": self.params,
            "iter": self.iteration,
        }


# the JAX package's collective primitives, and the c10d / functional
# collectives of an aten graph and the functional ones' wait (by op,
# without the overload)
COMM_PRIMITIVES = {
    "psum", "all_gather", "reduce_scatter", "all_to_all", "ppermute",
    "psum_scatter", "pmax", "pmin", "ragged_all_to_all", "collective_permute",
    "all_reduce",
} | set(TORCH_COMMS) | {"_c10d_functional::wait_tensor"}


class ExecutionTrace:
    """Graph container and queries (reference: ExecutionTrace,
    execution_trace.py:360-731)."""

    def __init__(self, data: Dict[str, Any]):
        if data.get("schema") not in (SCHEMA, JAX_SCHEMA):
            raise ValueError(
                f"unsupported ET schema {data.get('schema')!r}; want "
                f"{SCHEMA} (or the JAX package's {JAX_SCHEMA})"
            )
        self.schema = data["schema"]
        self.tensors: Dict[int, TensorNode] = {}
        for tid, t in data.get("tensors", {}).items():
            self.tensors[int(tid)] = TensorNode(
                id=int(tid), shape=tuple(t["shape"]), dtype=t["dtype"]
            )
        self.nodes: Dict[int, Node] = {}
        for n in data.get("nodes", []):
            node = Node(
                id=n["id"],
                name=n["name"],
                parent_id=n.get("parent", 0),
                op=n.get("op", True),
                inputs=n.get("inputs", []),
                outputs=n.get("outputs", []),
                params=n.get("params", {}),
                iteration=n.get("iter", 0),
            )
            self.nodes[node.id] = node
        # wire parent/children and tensor producers/consumers
        for node in self.nodes.values():
            parent = self.nodes.get(node.parent_id)
            if parent is not None and parent is not node:
                parent.children.append(node)
            for tid in node.outputs:
                if tid in self.tensors:
                    self.tensors[tid].sources.add(node.id)
            for tid in node.inputs:
                if tid is not None and tid in self.tensors:
                    self.tensors[tid].sinks.add(node.id)
        self.in_tensors: List[int] = data.get("in_tensors", [])
        self.out_tensors: List[int] = data.get("out_tensors", [])
        # embedded constant values: tid -> {"v": ..., "dtype": str}
        self.const_tensors: Dict[int, Dict[str, Any]] = {
            int(t): c for t, c in data.get("const_tensors", {}).items()
        }

    # ------------------------------------------------------------- queries
    def get_nodes(self, clean: bool = False) -> List[Node]:
        """Sorted op nodes; ``clean`` drops label/scope nodes
        (reference: get_nodes + remove_dataloader_ops:828)."""
        nodes = sorted(self.nodes.values(), key=lambda n: n.id)
        if clean:
            nodes = [n for n in nodes if n.op]
        return nodes

    def iterations(self) -> int:
        """(reference: set_iterations:602)"""
        return max((n.iteration for n in self.nodes.values()), default=0) + 1

    def comm_nodes(self) -> List[Node]:
        return [n for n in self.get_nodes(clean=True) if n.is_comm()]

    def compute_nodes(self) -> List[Node]:
        return [n for n in self.get_nodes(clean=True) if not n.is_comm()]

    # -------------------------------------------------------------- export
    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": self.schema,
            "nodes": [n.to_json() for n in self.get_nodes()],
            "tensors": {t.id: t.to_json() for t in self.tensors.values()},
            "const_tensors": {str(t): c for t, c in self.const_tensors.items()},
            "in_tensors": self.in_tensors,
            "out_tensors": self.out_tensors,
        }

    def save(self, path: str) -> None:
        data = self.to_json()
        if path.endswith(".gz"):
            import gzip

            with gzip.open(path, "wt") as f:
                json.dump(data, f)
        else:
            with open(path, "w") as f:
                json.dump(data, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "ExecutionTrace":
        from param_tpu_torch.trace.comms_trace import read_trace_file

        return cls(read_trace_file(path))

    def to_graphviz(self) -> str:
        """DOT export (reference: gen_graphviz:685-731)."""
        lines = ["digraph et {"]
        for n in self.get_nodes(clean=True):
            lines.append(f'  n{n.id} [label="{n.name}#{n.id}"];')
            for tid in n.inputs:
                if tid is not None and tid in self.tensors:
                    for src in self.tensors[tid].sources:
                        if src != n.id:
                            lines.append(f"  n{src} -> n{n.id};")
        lines.append("}")
        return "\n".join(lines)


class TraceValidator:
    """Sanity checks (reference: tools/validate_trace.py:25+)."""

    def __init__(self, et: ExecutionTrace):
        self.et = et

    def validate(self) -> List[str]:
        errors = []
        for n in self.et.get_nodes(clean=True):
            for tid in n.outputs:
                if tid not in self.et.tensors:
                    errors.append(f"node {n.id} outputs unknown tensor {tid}")
            for tid in n.inputs:
                if tid is not None and tid not in self.et.tensors:
                    errors.append(f"node {n.id} reads unknown tensor {tid}")
        # every non-input tensor must have a producer or an embedded const
        for t in self.et.tensors.values():
            if (
                not t.sources
                and t.id not in self.et.in_tensors
                and t.id not in self.et.const_tensors
            ):
                errors.append(f"tensor {t.id} has no producer")
        ids = [n.id for n in self.et.get_nodes()]
        if len(ids) != len(set(ids)):
            errors.append("duplicate node ids")
        return errors

    def num_ops(self) -> int:
        return len(self.et.get_nodes(clean=True))

    def num_comm_ops(self) -> int:
        return len(self.et.comm_nodes())
