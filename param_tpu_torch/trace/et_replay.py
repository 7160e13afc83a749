"""Op-level execution-trace replay and its code generator (the port's
``param_tpu/trace/et_replay.py``; PARAM's ``et_replay/tools/et_replay.py``,
``ExgrReplayManager``).

Subgraph selection by mode (full / comp / comm, ReplayMode:134), tensor
liveness over the concatenated iterations (analyze_tensors:585-717), pre-
allocated or lazy tensors (TensorAllocationMode:121), one call per node
rebuilt from its recorded op and arguments (build_func:829), a skip config
that a failing node joins (remove_op_with_runtime_error:1299), and QPS.

The op registry resolves a node name ``ns::op.overload`` to
``torch.ops.<ns>.<op>.<overload>``: aten ops, and K1 / K2 as
``param_tpu_torch::emb_gather`` / ``::sparse_update`` (on the card their
replay launches the kernels).  A c10d node resolves to the
``torch.distributed`` call that issues that op (``TORCH_COMMS``'s
``replay``; a torchbind ``ReduceOp`` cannot be built from Python), on the
group rebuilt over the live world, and waits for it as the eager call did
before a later node reads its buffers; a c10d op that table lacks is an
error.  The JAX module's scope replay (``_scope_body``,
``_exec_node``, ``_bind_scan``, ``_replay_scope``) has nothing to replay in
an aten graph and is not ported; a JAX-package trace is refused.
"""

from __future__ import annotations

import inspect
import json
import logging
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch
import torch.distributed as dist

from param_tpu_torch.trace.capture import decode_value
from param_tpu_torch.trace.comms_trace import TORCH_COMMS, op_base
from param_tpu_torch.trace.execution_trace import (
    JAX_SCHEMA, ExecutionTrace, Node,
)
from param_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


class ReplayMode(str, Enum):
    FULL = "full"
    COMPUTE = "comp"
    COMM = "comm"


class AllocationMode(str, Enum):
    PRE = "pre"  # allocate every replay tensor up front
    LAZY = "lazy"  # allocate on first use, free after last use


def resolve_op(name: str) -> Callable:
    """``ns::op.overload`` -> the callable that replays it (KeyError when
    this torch has no such op)."""
    base = op_base(name)
    if base.startswith("c10d::"):
        comm = TORCH_COMMS.get(base)
        if comm is None or comm.replay is None:
            raise KeyError(f"no replay call for {name}")
        fn = comm.replay
    else:
        if "::" not in name or "." not in name:
            raise KeyError(f"no op for {name}")
        ns, rest = name.split("::", 1)
        opname, overload = rest.rsplit(".", 1)
        if ns == "param_tpu_torch":
            import param_tpu_torch.kernels  # noqa: F401  (registers K1, K2)
        try:
            fn = getattr(getattr(getattr(torch.ops, ns), opname), overload)
        except (AttributeError, RuntimeError) as e:
            raise KeyError(f"no op for {name}: {e}") from None
        if _group_name_pos(fn) is not None:
            fn = _on_live_group(fn)
    return fn


def _group_name_pos(op) -> Optional[int]:
    """Position of a functional collective's ``group_name`` argument (None
    for any other op)."""
    names = [a.name for a in op._schema.arguments]
    return names.index("group_name") if "group_name" in names else None


def _on_live_group(op):
    """A functional collective with its recorded group name swapped for the
    live default group's."""
    pos = _group_name_pos(op)

    def call(*args, **kwargs):
        args = list(args)
        if pos < len(args):
            args[pos] = dist.group.WORLD.group_name
        else:
            kwargs["group_name"] = dist.group.WORLD.group_name
        return op(*args, **kwargs)

    return call


def flat_tensors(x) -> List[torch.Tensor]:
    """The tensor leaves of an op's result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in flat_tensors(y)]
    return []


@dataclass
class ReplayConfig:
    """(reference: skip-node replay config JSON,
    configs/replay-config-fbgemm.json)"""

    skip_nodes: Set[int] = field(default_factory=set)
    skip_names: Set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path: str) -> "ReplayConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            skip_nodes=set(raw.get("skip_nodes", [])),
            skip_names=set(raw.get("skip_names", [])),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"skip_nodes": sorted(self.skip_nodes),
                 "skip_names": sorted(self.skip_names)},
                f, indent=2,
            )


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class EtReplayManager:
    """(reference: ExgrReplayManager, tools/et_replay.py:1384+)

    ``inputs`` / ``inputs_file`` (.npz by tensor id) give input values in
    place of random ones; each iteration starts from a fresh copy of them
    on ``device``, so a step that updates its inputs in place starts every
    iteration from the same state and leaves the caller's tensors alone."""

    def __init__(
        self,
        et: ExecutionTrace,
        mode: ReplayMode = ReplayMode.FULL,
        alloc: AllocationMode = AllocationMode.PRE,
        config: Optional[ReplayConfig] = None,
        seed: int = 0,
        inputs_file: Optional[str] = None,
        inputs: Optional[Dict[int, Any]] = None,
        device="cuda",
    ):
        if et.schema == JAX_SCHEMA:
            raise ValueError(
                f"ET schema {JAX_SCHEMA} is the JAX package's jaxpr trace: "
                "replay it op by op with the JAX package "
                "(param_tpu.trace.et_replay); here only its comm ops replay "
                "(cli.replay --trace-type et)")
        self.et = et
        self.mode = ReplayMode(mode)
        self.alloc = AllocationMode(alloc)
        self.config = config or ReplayConfig()
        self.seed = seed
        self.device = resolve_device(device)
        self.inputs: Dict[int, Any] = dict(inputs or {})
        if inputs_file:
            loaded = np.load(inputs_file)
            self.inputs = {int(k): loaded[k] for k in loaded.files}
        self.registry: Dict[int, torch.Tensor] = {}  # tensor id -> value
        self.consts: Dict[int, torch.Tensor] = {
            tid: torch.tensor(c["v"], dtype=_torch_dtype(c["dtype"]),
                              device=self.device)
            for tid, c in et.const_tensors.items()
        }
        self.last_use: Dict[int, int] = {}
        self.skipped: List[int] = []
        self.errors: Dict[int, str] = {}
        self._nodes: List[Node] = []
        self._ops: Dict[str, Callable] = {}  # node name -> resolve_op's

    # ------------------------------------------------------------- analysis
    def preprocess(self) -> None:
        """Subgraph selection and liveness (reference: preprocess_graph:1344,
        analyze_tensors:585).  Every recorded iteration replays in order;
        they share tensor ids, so liveness runs over the concatenated
        schedule and ``_iter_bounds`` marks where each starts."""
        all_nodes = self.et.get_nodes(clean=True)

        def select(nodes):
            if self.mode == ReplayMode.COMM:
                return [n for n in nodes if n.is_comm()]
            if self.mode == ReplayMode.COMPUTE:
                return [n for n in nodes if not n.is_comm()]
            return list(nodes)

        schedule: List[Node] = []
        self._iter_bounds: List[int] = []
        for it in sorted({n.iteration for n in all_nodes} or {0}):
            self._iter_bounds.append(len(schedule))
            schedule.extend(select([n for n in all_nodes
                                    if n.iteration == it]))
        self._nodes = schedule
        self.last_use.clear()
        for pos, n in enumerate(schedule):
            for tid in n.inputs:
                if tid is not None:
                    self.last_use[tid] = pos
        for tid in self.et.out_tensors:
            self.last_use[tid] = len(schedule)

    def _alloc_tensor(self, tid: int, rng: np.random.Generator):
        """Random values of the tensor's shape and dtype: integers in [0, 8),
        floats in [0, 1) drawn in f32 and cast (numpy has no bfloat16)."""
        t = self.et.tensors[tid]
        dtype = _torch_dtype(t.dtype)
        shape = tuple(t.shape)
        if dtype == torch.bool:
            arr = rng.integers(0, 2, size=shape).astype(bool)
        elif dtype.is_floating_point or dtype.is_complex:
            arr = rng.random(size=shape).astype(np.float32)
        else:
            arr = rng.integers(0, 8, size=shape).astype(np.int64)
        return torch.from_numpy(arr).to(device=self.device, dtype=dtype)

    def allocate_inputs(self) -> None:
        """(reference: allocate_tensors:719; replay inputs are random
        unless given)"""
        rng = np.random.default_rng(self.seed)
        needed: Set[int] = set(self.et.in_tensors)
        produced: Set[int] = set()
        for n in self._nodes:
            for tid in n.inputs:
                if tid is not None and tid not in produced:
                    needed.add(tid)
            produced.update(t for t in n.outputs if t is not None)
        self.registry.update(self.consts)
        for tid, arr in self.inputs.items():
            if tid in self.et.tensors:
                self.registry[tid] = torch.as_tensor(arr).detach().to(
                    self.device, copy=True)
        if self.alloc == AllocationMode.PRE:
            for tid in sorted(needed):
                if tid in self.et.tensors and tid not in self.registry:
                    self.registry[tid] = self._alloc_tensor(tid, rng)
        else:
            self._lazy_rng = rng

    def _get_input(self, tid: int) -> torch.Tensor:
        if tid in self.registry:
            return self.registry[tid]
        if self.alloc == AllocationMode.LAZY and tid in self.et.tensors:
            self.registry[tid] = self._alloc_tensor(tid, self._lazy_rng)
            return self.registry[tid]
        raise KeyError(f"tensor {tid} unavailable")

    def _group_for(self, desc: Dict[str, Any]):
        """The live group for a recorded one: the default group when the
        recorded world is the live one (``_mesh_for``'s counterpart)."""
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("a comm node needs torch.distributed's default "
                             "process group")
        world = dist.get_world_size()
        if desc.get("size") != world:
            raise ValueError(f"recorded group of {desc.get('size')} ranks, "
                             f"live world of {world}")
        return dist.group.WORLD

    def _resolve(self, v):
        """A decoded argument with tensor references resolved."""
        if isinstance(v, list):
            return [self._resolve(x) for x in v]
        if isinstance(v, dict):
            if "__tensor__" in v:
                return self._get_input(v["__tensor__"])
            return {k: self._resolve(x) for k, x in v.items()}
        return v

    def call_args(self, node: Node):
        """(positional, keyword) arguments of ``node``'s call."""
        p = node.params
        args = self._resolve(decode_value(p.get("args", []), self.device,
                                          self._group_for))
        kwargs = self._resolve(decode_value(p.get("kwargs", {}), self.device,
                                            self._group_for))
        return args, kwargs

    # --------------------------------------------------------------- replay
    def run_op(self, pos: int, node: Node) -> None:
        """(reference: run_op:1125)"""
        if (
            node.id in self.config.skip_nodes
            or node.name in self.config.skip_names
        ):
            self._skip(node)
            return
        try:
            fn = self._ops.get(node.name)
            if fn is None:
                fn = self._ops[node.name] = resolve_op(node.name)
            args, kwargs = self.call_args(node)
            out = fn(*args, **kwargs)
            n_out = node.params.get("n_out", len(node.outputs))
            for tid, val in zip(node.outputs[:n_out], flat_tensors(out)):
                self.registry[tid] = val
        except Exception as e:  # noqa: BLE001
            # reference behaviour: record the failure, allocate the outputs
            # so the rest of the graph continues
            # (remove_op_with_runtime_error:1299)
            self.errors[node.id] = f"{node.name}: {str(e)[:160]}"
            self.config.skip_nodes.add(node.id)
            self._skip(node)

    def _skip(self, node: Node) -> None:
        """Random outputs for a skipped node; an argument it would have
        written keeps its value."""
        self.skipped.append(node.id)
        rng = np.random.default_rng(self.seed + node.id)
        for tid in node.outputs:
            if tid in self.et.tensors and tid not in self.registry:
                self.registry[tid] = self._alloc_tensor(tid, rng)

    def _free_dead(self, pos: int) -> None:
        """(reference: tensor registry free by last-use, :1209-1237)"""
        if self.alloc != AllocationMode.LAZY:
            return
        dead = [tid for tid, last in self.last_use.items()
                if last == pos and tid in self.registry]
        for tid in dead:
            del self.registry[tid]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def replay(
        self, iters: int = 1, warmup: int = 0, per_op: bool = False
    ) -> Dict[str, Any]:
        """(reference: benchTime:1384 / run_iter:1455)

        ``per_op``: also record each op's blocking wall latency on the last
        iteration (the issue cost included: for relative comparisons)."""
        self.preprocess()
        times = []
        iter_times: List[float] = []
        bounds = set(self._iter_bounds[1:])  # starts of iterations > 0
        op_times: Dict[str, Dict] = {}
        for it in range(warmup + iters):
            self.registry.clear()
            self.skipped.clear()
            self.allocate_inputs()
            self._sync()
            last = it == warmup + iters - 1
            record_ops = per_op and last
            record_iters = last and len(bounds) > 0
            t0 = time.perf_counter()
            it0 = t0
            for pos, node in enumerate(self._nodes):
                if record_iters and pos in bounds:
                    self._sync()
                    now = time.perf_counter()
                    iter_times.append(now - it0)
                    it0 = now
                if record_ops:
                    o0 = time.perf_counter()
                self.run_op(pos, node)
                if record_ops:
                    self._sync()
                    d = op_times.setdefault(node.name,
                                            {"count": 0, "total_us": 0.0})
                    d["count"] += 1
                    d["total_us"] += (time.perf_counter() - o0) * 1e6
                self._free_dead(pos)
            self._sync()
            now = time.perf_counter()
            if record_iters:
                iter_times.append(now - it0)
            if it >= warmup:
                times.append(now - t0)
        total = sum(times) / max(1, len(times))
        out = {
            "mode": self.mode.value,
            "num_ops": len(self._nodes),
            "num_skipped": len(set(self.skipped)),
            "errors": dict(self.errors),
            "iter_s": total,
            "qps": len(self._nodes) / total if total else 0.0,
            "trace_iterations": len(self._iter_bounds),
        }
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            out["device_memory"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            }
        if iter_times:
            out["per_iteration_s"] = iter_times
        if op_times:
            out["per_op_us"] = dict(
                sorted(op_times.items(), key=lambda kv: -kv[1]["total_us"]))
        return out

    def outputs(self) -> List[torch.Tensor]:
        """The trace's out tensors after a replay."""
        return [self.registry[t] for t in self.et.out_tensors]


# --------------------------------------------------------------- codegen
_CODEGEN_HEADER = '''\
"""Standalone replay script generated by param_tpu_torch (cli.et codegen).

PARAM et_replay's code-generator mode (-g).  Each line below is one
recorded op; edit freely.  Needs only torch and numpy{kernels_note}.

    python {{this file}} [--device cuda|cpu]
{comm_note}"""

import argparse

import numpy as np
import torch
{imports}
ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
DEV = torch.device(ap.parse_args().device)
torch.set_grad_enabled(False)
rng = np.random.default_rng(0)
nan, inf = float("nan"), float("inf")  # appear in repr'd op arguments


def T(shape, dtype):
    """Random values of a shape and dtype: integers in [0, 8), floats in
    [0, 1) drawn in f32 and cast."""
    d = getattr(torch, dtype)
    if d == torch.bool:
        a = rng.integers(0, 2, size=shape).astype(bool)
    elif d.is_floating_point or d.is_complex:
        a = rng.random(size=shape).astype(np.float32)
    else:
        a = rng.integers(0, 8, size=shape).astype(np.int64)
    return torch.from_numpy(a).to(device=DEV, dtype=d)


def C(v, dtype):
    return torch.tensor(v, dtype=getattr(torch, dtype), device=DEV)


def F(x):
    """The tensor leaves of an op's result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in F(y)]
    return []

'''

_CODEGEN_COMM = '''
import os

import torch.distributed as dist

# the default group from the torchrun environment (a world of one without)
for _k, _v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR",
               "localhost"), ("MASTER_PORT", "29547")):
    os.environ.setdefault(_k, _v)
if DEV.type == "cuda":
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    DEV = torch.device("cuda", torch.cuda.current_device())
dist.init_process_group("nccl" if DEV.type == "cuda" else "gloo")
WORLD = dist.group.WORLD


def G(size):
    if size != dist.get_world_size():
        raise ValueError(f"recorded group of {size} ranks, live world of "
                         f"{dist.get_world_size()}")
    return WORLD
'''


def _c10d_source(bases: List[str]) -> str:
    """The replay calls of the trace's c10d ops (KeyError for one that
    ``TORCH_COMMS`` cannot replay), and ``C10D``, mapping each op to its
    call."""
    fns = {}
    for base in bases:
        comm = TORCH_COMMS.get(base)
        if comm is None or comm.replay is None:
            raise KeyError(f"no replay call for {base}")
        fns[base] = comm.replay
    src = [inspect.getsource(fn) for fn in dict.fromkeys(fns.values())]
    table = "".join(f"    {b!r}: {fn.__name__},\n" for b, fn in fns.items())
    return "\n" + "\n\n".join(src) + "\n\nC10D = {\n" + table + "}\n"


def _render(v, names: Set[int]) -> str:
    """Python source of an encoded argument; tensor references render as
    their names (``names`` collects the ids used)."""
    if isinstance(v, list):
        return "[" + ", ".join(_render(x, names) for x in v) + "]"
    if isinstance(v, dict):
        if "__tensor__" in v:
            names.add(v["__tensor__"])
            return f"t{v['__tensor__']}"
        if "__dtype__" in v:
            return f"torch.{v['__dtype__']}"
        if "__device__" in v:
            return "DEV"
        if "__layout__" in v:
            return f"torch.{v['__layout__']}"
        if "__memory_format__" in v:
            return f"torch.{v['__memory_format__']}"
        if "__reduce_op__" in v:
            return f"dist.ReduceOp.{v['__reduce_op__']}"
        if "__group__" in v:
            return f"G({v['__group__'].get('size')})"
        if "__opaque__" in v:
            raise ValueError(f"opaque argument {v['__opaque__']}")
        return "{" + ", ".join(f"{k!r}: {_render(x, names)}"
                               for k, x in v.items()) + "}"
    return repr(v)


def _define_missing(et: ExecutionTrace, tids, lines, emitted) -> None:
    for tid in tids:
        if tid not in emitted:
            t = et.tensors[tid]
            lines.append(f"t{tid} = T({tuple(t.shape)}, {t.dtype!r})")
            emitted.add(tid)


def _emit_op(node: Node, et: ExecutionTrace, lines, emitted) -> None:
    base = op_base(node.name)
    refs: Set[int] = set()
    args = [_render(a, refs) for a in node.params.get("args", [])]
    kwargs = [f"{k}={_render(a, refs)}"
              for k, a in node.params.get("kwargs", {}).items()]
    _define_missing(et, sorted(refs), lines, emitted)
    if base.startswith("c10d::"):
        # in place on its buffers, as the replay's call
        lines.append(f"C10D[{base!r}]({', '.join(args)})")
        emitted.update(node.outputs)
        return
    ns, rest = node.name.split("::", 1)
    opname, overload = rest.rsplit(".", 1)
    if ns == "_c10d_functional":
        pos = _group_name_pos(getattr(getattr(getattr(torch.ops, ns), opname),
                                      overload))
        if pos is not None and pos < len(args):
            args[pos] = "WORLD.group_name"
    call = f"torch.ops.{ns}.{opname}.{overload}({', '.join(args + kwargs)})"
    n_out = node.params.get("n_out", len(node.outputs))
    outs = [f"t{t}" for t in node.outputs[:n_out]]
    lines.append(f"{', '.join(outs)}, *_ = F({call})" if outs else call)
    emitted.update(node.outputs)


def generate_code(et: ExecutionTrace) -> str:
    """A standalone Python replay script of the trace's first iteration
    (PARAM et_replay's code-generator mode, et_replay.py -g): one
    ``torch.ops`` call per node (a c10d node's ``torch.distributed`` call on
    the default group set up from the torchrun environment), inputs drawn
    as ``T(shape, dtype)`` draws them, ``--device`` defaulting to cuda; it
    ends by printing ``replayed N ops OK``."""
    if et.schema == JAX_SCHEMA:
        raise ValueError(f"ET schema {JAX_SCHEMA} is the JAX package's: "
                         "generate its script with the JAX package")
    nodes = [n for n in et.get_nodes(clean=True) if n.iteration == 0]
    kernels = any(n.name.startswith("param_tpu_torch::") for n in nodes)
    c10d = sorted({op_base(n.name) for n in nodes
                   if n.name.startswith("c10d::")})
    comm = bool(c10d) or any(n.name.startswith("_c10d_functional::")
                             for n in nodes)
    imports = ("\nimport param_tpu_torch.kernels  # noqa: F401  "
               "(registers K1 / K2)\n" if kernels else "")
    header = _CODEGEN_HEADER.format(
        kernels_note=(", and param_tpu_torch for its kernels' ops"
                      if kernels else ""),
        comm_note=("\nIts collectives run on the default group: launch it "
                   "with torchrun\nfor more than one rank.\n" if comm else ""),
        imports=imports)
    lines = [header]
    if comm:
        lines.append(_CODEGEN_COMM)
        lines.append(_c10d_source(c10d))
    lines.append("# ---- inputs and constants " + "-" * 36)
    emitted: Set[int] = set()
    for tid in et.in_tensors:
        _define_missing(et, [tid], lines, emitted)
    for tid, c in sorted(et.const_tensors.items()):
        lines.append(f"t{tid} = C({c['v']!r}, {c['dtype']!r})")
        emitted.add(tid)
    lines.append("")
    lines.append("# ---- ops " + "-" * 53)
    for node in nodes:
        _emit_op(node, et, lines, emitted)
    lines.append("")
    lines.append('if DEV.type == "cuda":')
    lines.append("    torch.cuda.synchronize(DEV)")
    lines.append(f'print("replayed {len(nodes)} ops OK")')
    if comm:
        lines.append("dist.destroy_process_group()")
    return "\n".join(lines) + "\n"
