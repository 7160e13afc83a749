"""Every public name of ``param_tpu`` has its counterpart in
``param_tpu_torch``, or is a deliberate leave-out listed here.

Both packages are read as source (``ast``), so neither is imported.  A
module's public names are its top-level functions, classes and assigned
names that do not start with ``_``; a package ``__init__``'s are also the
names it imports (its exports).  A name counts as ported when the
counterpart module (the same path under ``param_tpu_torch/``) defines or
imports it.  ``LEAVE_OUTS`` mirrors ROADMAP.md's "Deliberate leave-outs".
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "param_tpu", ROOT / "param_tpu_torch"

# modules of the reference with no counterpart: module -> reason
MODULE_LEAVE_OUTS = {
    "trace/hlo_summary.py": "XLA HLO dumps; no XLA runs in the port",
    "comms/timing.py": "scalar-fetch timing chains for a remote relay; the "
                       "port times with CUDA events (utils/timer.py)",
    "backend/tpu_backend.py": "shard_map collectives over a mesh; "
                              "backend/dist_backend.py replaced it",
}

# public names of a ported module that the port leaves out: module ->
# {name: reason}
LEAVE_OUTS = {
    "backend/__init__.py": {
        "TpuBackend": "backend/dist_backend.DistBackend replaced it"},
    "comms/__init__.py": {
        "measure_dispatch": "comms/timing.py: a relay workaround",
        "measure_graph": "comms/timing.py: a relay workaround"},
    "ops/__init__.py": {
        "embedding_bag_pallas": "K1 is kernels/emb_gather.emb_gather"},
    "ops/embedding.py": {
        "embedding_bag_pallas": "K1 is kernels/emb_gather.emb_gather",
        "pad_table_dim": "a TPU lane layout"},
    "ops/sparse_update.py": {
        "pack_rows_to_lanes": "lane packing of the TPU's row update"},
    "ops/matmul_tune.py": {
        "BlockCandidate": "Pallas VMEM blocks; the port ranks K3 schedules "
                          "(ScheduleCandidate)",
        "vmem_bytes": "Pallas VMEM budget; see candidate_blocks"},
    "trace/capture.py": {
        "encode_params": "jaxpr equation params",
        "decode_params": "jaxpr equation params"},
    "trace/et_replay.py": {
        "bind_node": "jaxpr primitives; the port replays aten nodes",
        "primitive_registry": "jaxpr primitives; the port replays aten "
                              "nodes"},
    "microbench/operator.py": {
        "JaxPathOp": "the port's TorchPathOp"},
    "models/dlrm.py": {"AXIS": "a mesh axis name"},
    "models/moe.py": {"moe_param_specs": "PartitionSpecs"},
    "models/transformer.py": {
        "param_specs": "PartitionSpecs",
        "place": "device_put onto a mesh"},
    "utils/chip.py": {"CHIPS": "the TPU chip table; the port has the "
                               "H100's constants"},
    "comms/overlap_bench.py": {"log": "the module's logger"},
    "ops/compute_bench.py": {"log": "the module's logger"},
    "utils/profiler.py": {"log": "the module's logger"},
}


def _names(path: pathlib.Path, with_imports: bool) -> set:
    """Public top-level names of ``path``: definitions and assignments,
    also inside top-level ``if`` / ``try`` blocks; imports too when
    ``with_imports``."""
    out = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            out.add(n.id)
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                out.add(node.target.id)
            elif with_imports and isinstance(node, (ast.Import,
                                                    ast.ImportFrom)):
                out.update(a.asname or a.name.split(".")[0]
                           for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                for part in (node.body, node.orelse, node.finalbody,
                             *(h.body for h in node.handlers)):
                    visit(part)

    visit(ast.parse(path.read_text()).body)
    return {n for n in out if not n.startswith("_")}


def _ref_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _public(rel: str) -> set:
    return _names(REF / rel, with_imports=rel.endswith("__init__.py"))


@pytest.mark.parametrize("rel", _ref_modules())
def test_every_public_name_is_ported_or_left_out(rel):
    if rel in MODULE_LEAVE_OUTS:
        assert not (PORT / rel).exists(), (
            f"{rel} is ported now: take it out of MODULE_LEAVE_OUTS")
        return
    assert (PORT / rel).exists(), f"param_tpu_torch/{rel} is missing"
    have = _names(PORT / rel, with_imports=True)
    left = LEAVE_OUTS.get(rel, {})
    missing = sorted(_public(rel) - have - set(left))
    assert not missing, (
        f"param_tpu/{rel} names {missing} that param_tpu_torch/{rel} "
        f"lacks; port them or list them as leave-outs")


def test_leave_outs_are_current():
    """Each leave-out is a public name of the reference that the port
    really lacks, so the list shrinks when a name is ported."""
    refs = set(_ref_modules())
    assert set(MODULE_LEAVE_OUTS) <= refs
    stale = []
    for rel, names in LEAVE_OUTS.items():
        assert rel in refs and rel not in MODULE_LEAVE_OUTS, rel
        have = _names(PORT / rel, with_imports=True)
        stale += [f"{rel}:{n}" for n in names
                  if n not in _public(rel) or n in have]
    assert not stale, stale
    assert all(LEAVE_OUTS.values()) and all(
        reason for names in LEAVE_OUTS.values() for reason in names.values())


@pytest.mark.parametrize("package", ["utils", "ops", "models", "comms",
                                     "backend"])
def test_package_exports_resolve(package):
    """The port's package exports are importable attributes (the AST check
    above sees only that they are named)."""
    import importlib

    mod = importlib.import_module(f"param_tpu_torch.{package}")
    want = _public(f"{package}/__init__.py") - set(
        LEAVE_OUTS.get(f"{package}/__init__.py", {}))
    assert want and all(hasattr(mod, n) for n in want), sorted(
        n for n in want if not hasattr(mod, n))
