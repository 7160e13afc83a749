"""Execution-trace capture: an eager PyTorch function -> ET JSON (the port's
``param_tpu/trace/capture.py``).

``make_fx(fn, tracing_mode="real")`` runs ``fn`` once on its real inputs
and records every op that reaches the dispatcher as one node of a flat
aten graph: the backward of a ``torch.autograd.grad`` inside ``fn``, the
in-place optimizer updates, the c10d collectives, and K1 / K2 (registered
as the ops ``param_tpu_torch::emb_gather`` / ``::sparse_update``, so a
ctypes launch cannot slip past the recorder).  The graph maps onto the ET
layout of :mod:`.execution_trace`:

- placeholders (the tensor leaves of ``args`` in ``torch.utils._pytree``
  order) are ``in_tensors``; the output node's tensors ``out_tensors``;
- ``operator.getitem`` nodes fold into their producer's ``outputs``;
- a result that is a written argument (``add_``'s ``Tensor(a!)``, a c10d
  op's in-place buffer) keeps that argument's tensor id, so an output that
  is a mutated input keeps the input's id; arguments an op writes without
  returning them (``sparse_update``'s table) follow its results in
  ``outputs``;
- ``get_attr`` tensor constants are embedded when small (at most 65536
  elements) and become replay inputs otherwise, with a warning;
- the non-tensor arguments go to ``params`` as ``{"args": [...],
  "kwargs": {...}}`` with tensors as ``{"__tensor__": tid}`` and markers
  for what JSON cannot hold: ``__dtype__``, ``__layout__``,
  ``__memory_format__``, ``__device__`` (the replay puts its own device
  there, so a trace taken on the CPU replays on the card and the
  reverse), ``__group__`` (a process group's size, ranks and this rank;
  the ``__mesh__`` descriptor's counterpart) and ``__reduce_op__``.

``fn`` runs for real, so a step that updates its inputs in place has
updated them when the capture returns: capture copies.  The JAX module's
``_INLINE`` / ``_OPAQUE`` scopes (scan, while, cond, shard_map) have no
counterpart here: an eager PyTorch program's control flow unrolls at
capture, and there is no scope node to replay.
"""

from __future__ import annotations

import logging
import operator
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.fx import Node as FxNode
from torch.utils import _pytree as pytree

from param_tpu_torch.trace.comms_trace import TORCH_COMMS, op_base
from param_tpu_torch.trace.execution_trace import SCHEMA, ExecutionTrace

log = logging.getLogger(__name__)

MAX_CONST_ELEMS = 65536


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def op_name(target) -> str:
    """``ns::op.overload`` of an op overload (a plain callable's module and
    name)."""
    schema = getattr(target, "_schema", None)
    if schema is not None:
        return f"{schema.name}.{target._overloadname}"
    return (f"{getattr(target, '__module__', '')}."
            f"{getattr(target, '__name__', str(target))}")


class _Obj:
    """A non-tensor ``get_attr`` value (a torchbind process group or reduce
    op)."""

    def __init__(self, value):
        self.value = value


def _encode_script_object(obj) -> Dict[str, Any]:
    kind = obj._type().qualified_name() if hasattr(obj, "_type") else ""
    if kind.endswith("c10d.ProcessGroup"):
        pg = dist.ProcessGroup.unbox(obj)
        return {"__group__": {"size": pg.size(),
                              "ranks": dist.get_process_group_ranks(pg),
                              "rank": dist.get_rank()}}
    if kind.endswith("c10d.ReduceOp"):
        return {"__reduce_op__": dist.ReduceOp.RedOpType(obj.op()).name}
    return {"__opaque__": kind or type(obj).__name__}


def encode_value(v, env: Dict[FxNode, Any], tids: Optional[List[int]] = None):
    """One argument of an fx node as JSON: tensors as ``{"__tensor__":
    tid}`` (each appended to ``tids``), markers for dtypes, layouts, memory
    formats, devices and torchbind objects."""

    def enc(x):
        if isinstance(x, FxNode):
            return enc_desc(env[x])
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        if isinstance(x, torch.dtype):
            return {"__dtype__": dtype_name(x)}
        if isinstance(x, torch.device):
            return {"__device__": x.type}
        if isinstance(x, torch.layout):
            return {"__layout__": str(x).replace("torch.", "")}
        if isinstance(x, torch.memory_format):
            return {"__memory_format__": str(x).replace("torch.", "")}
        if isinstance(x, (list, tuple)):
            return [enc(y) for y in x]
        if isinstance(x, dict):
            return {str(k): enc(y) for k, y in x.items()}
        return {"__opaque__": type(x).__name__}

    def enc_desc(d):
        if isinstance(d, int):
            if tids is not None:
                tids.append(d)
            return {"__tensor__": d}
        if isinstance(d, list):
            return [enc_desc(y) for y in d]
        if isinstance(d, _Obj):
            return _encode_script_object(d.value)
        return None

    return enc(v)


def decode_value(v, device, group_for=None):
    """Inverse of :func:`encode_value` for everything but tensors (left as
    ``{"__tensor__": tid}``): ``__device__`` becomes ``device``,
    ``__group__`` ``group_for(descriptor)``."""
    if isinstance(v, list):
        return [decode_value(x, device, group_for) for x in v]
    if not isinstance(v, dict):
        return v
    if "__tensor__" in v:
        return v
    if "__dtype__" in v:
        return getattr(torch, v["__dtype__"])
    if "__device__" in v:
        return torch.device(device)
    if "__layout__" in v:
        return getattr(torch, v["__layout__"])
    if "__memory_format__" in v:
        return getattr(torch, v["__memory_format__"])
    if "__reduce_op__" in v:
        return getattr(dist.ReduceOp, v["__reduce_op__"])
    if "__group__" in v:
        if group_for is None:
            raise ValueError("a process-group argument needs a group")
        return group_for(v["__group__"])
    if "__opaque__" in v:
        raise ValueError(f"an opaque argument ({v['__opaque__']}) cannot "
                         "be rebuilt")
    return {k: decode_value(x, device, group_for) for k, x in v.items()}


def flat_tids(desc) -> List[int]:
    if isinstance(desc, int):
        return [desc]
    if isinstance(desc, list):
        return [t for d in desc for t in flat_tids(d)]
    return []


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``torch.utils._pytree`` order: a
    capture's ``in_tensors`` for its ``args``, its ``out_tensors`` for the
    function's result."""
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def inputs_for(et: ExecutionTrace, *args) -> Dict[int, torch.Tensor]:
    """``{tid: tensor}`` of the trace's inputs from the arguments it was
    captured with (an ``EtReplayManager``'s ``inputs=``)."""
    return dict(zip(et.in_tensors, tensor_leaves(args)))


class _Capture:
    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.nodes: List[dict] = []
        self.tensors: Dict[int, dict] = {}
        self.const_vals: Dict[int, dict] = {}
        self.env: Dict[FxNode, Any] = {}
        self.in_ids: List[int] = []
        self.out_ids: List[int] = []
        self._next_tensor = 0
        self._next_node = 1  # 0 reserved for the root

    def new_tensor(self, t) -> int:
        tid = self._next_tensor
        self._next_tensor += 1
        self.tensors[tid] = {"shape": list(t.shape),
                             "dtype": dtype_name(t.dtype)}
        return tid

    def alloc(self, v, aliases=None):
        """Descriptor of a result: a tid for a tensor (the next of
        ``aliases`` when given), a list for a list / tuple, None else."""
        if isinstance(v, torch.Tensor):
            if aliases:
                return aliases.pop(0)
            return self.new_tensor(v)
        if isinstance(v, (list, tuple)):
            return [self.alloc(x, aliases) for x in v]
        return None

    def record_const(self, tid: int, t: torch.Tensor) -> None:
        if t.numel() <= MAX_CONST_ELEMS:
            self.const_vals[tid] = {"v": t.detach().cpu().tolist(),
                                    "dtype": dtype_name(t.dtype)}
        else:
            log.warning("const tensor %d (%s, %d elems) too large to embed; "
                        "it becomes a replay input", tid, t.dtype, t.numel())
            self.in_ids.append(tid)

    @staticmethod
    def _arg(node: FxNode, name: str, pos: int):
        if pos < len(node.args):
            return node.args[pos]
        return node.kwargs.get(name)

    def op_node(self, node: FxNode) -> None:
        target = node.target
        name = op_name(target)
        tids: List[int] = []
        params = {"args": encode_value(list(node.args), self.env, tids),
                  "kwargs": encode_value(dict(node.kwargs), self.env, tids)}
        val = node.meta.get("val")
        schema = getattr(target, "_schema", None)
        written: List[int] = []  # tids of the arguments the op writes
        comm = TORCH_COMMS.get(op_base(name))
        if comm is not None and comm.out_pos is not None:
            out_arg = (node.args[comm.out_pos]
                       if comm.out_pos < len(node.args) else None)
            written = flat_tids(self._desc_of(out_arg))
            desc = self.alloc(val, list(written))
        elif schema is not None:
            args = schema.arguments
            for i, a in enumerate(args):
                if a.alias_info is not None and a.alias_info.is_write:
                    written += flat_tids(self._desc_of(
                        self._arg(node, a.name, i)))
            rets = schema.returns
            vals = [val] if len(rets) == 1 else list(val or ())
            descs = []
            for r, v in zip(rets, vals):
                src = None
                if r.alias_info is not None and r.alias_info.is_write:
                    src = next((self._arg(node, a.name, i)
                                for i, a in enumerate(args)
                                if a.alias_info is not None
                                and a.alias_info.before_set
                                == r.alias_info.before_set), None)
                descs.append(self._desc_of(src) if src is not None
                             else self.alloc(v))
            desc = descs[0] if len(rets) == 1 else descs
        else:
            desc = self.alloc(val)
        self.env[node] = desc
        outputs = flat_tids(desc)
        params["n_out"] = len(outputs)  # results; then written arguments
        outputs += [t for t in written if t not in outputs]
        self.nodes.append({"id": self._next_node, "name": name, "parent": 0,
                           "op": True, "inputs": tids, "outputs": outputs,
                           "params": params, "iter": 0})
        self._next_node += 1

    def _desc_of(self, arg):
        if isinstance(arg, FxNode):
            return self.env.get(arg)
        if isinstance(arg, (list, tuple)):
            return [self._desc_of(a) for a in arg]
        return None

    def walk(self) -> None:
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                val = node.meta.get("val")
                if isinstance(val, torch.Tensor):
                    tid = self.new_tensor(val)
                    self.in_ids.append(tid)
                    self.env[node] = tid
                else:
                    self.env[node] = None
            elif node.op == "get_attr":
                obj = operator.attrgetter(node.target)(self.gm)
                if isinstance(obj, torch.Tensor):
                    tid = self.new_tensor(obj)
                    self.record_const(tid, obj)
                    self.env[node] = tid
                else:
                    self.env[node] = _Obj(obj)
            elif node.op == "call_function":
                if node.target is operator.getitem:
                    src, i = node.args
                    self.env[node] = self.env[src][i]
                else:
                    self.op_node(node)
            elif node.op == "output":
                found: List[FxNode] = []
                torch.fx.node.map_arg(node.args[0], found.append)
                self.out_ids = [t for n in found
                                for t in flat_tids(self.env.get(n))]
            else:
                raise ValueError(f"unexpected fx node {node.op} {node.target}")


def capture_execution_trace(fn, *args, iterations: int = 1) -> ExecutionTrace:
    """Run ``fn(*args)`` once under ``make_fx`` (real tensors) and return
    its ET.

    ``iterations`` > 1 stamps copies of the op stream with iteration tags
    (the ``ProfilerStep#`` segmentation analogue, reference
    set_iterations:602): the copies share tensor ids, as a steady-state
    training loop rewrites the same buffers."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn, tracing_mode="real")(*args)
    cap = _Capture(gm)
    cap.walk()
    data = {
        "schema": SCHEMA,
        "nodes": cap.nodes,
        "tensors": cap.tensors,
        "const_tensors": {str(t): c for t, c in cap.const_vals.items()},
        "in_tensors": cap.in_ids,
        "out_tensors": cap.out_ids,
    }
    if iterations > 1:
        base_nodes = list(data["nodes"])
        next_id = max(n["id"] for n in base_nodes) + 1 if base_nodes else 1
        for it in range(1, iterations):
            for n in base_nodes:
                clone = dict(n)
                clone["id"] = next_id
                clone["iter"] = it
                next_id += 1
                data["nodes"].append(clone)
    return ExecutionTrace(data)
