"""Export comm traces to the PyTorch-ET (Chakra host ET) schema (the
port's ``param_tpu/trace/export_pytorch_et.py``).

The reverse direction of ``trace/pytorch_et.py``: a recorded comm stream
(``cli.comms --trace-dump-et``) is written as a modern (>= 1.0.3) PyTorch
execution trace whose ``record_param_comms`` nodes carry the comm attrs, so
PyTorch trace tooling (PARAM's ``et_replay`` parser, Chakra converters)
can read it.

Round trip: exporting any CommsOp list and re-parsing it with
:func:`comms_from_pytorch_et` gives the same collectives, sizes, dtypes,
splits and roots.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Union

from param_tpu_torch.trace.comms_trace import CommsOp, P2P_OPS, parse_trace

SCHEMA = "1.0.4-chakra.0.0.4"

# dtype name -> torch trace token (inverse of
# pytorch_et._TORCH_DTYPES; tokens chosen from the identity rows so the
# round trip is exact)
_EXPORT_DTYPES = {
    "float32": "float",
    "float64": "double",
    "float16": "half",
    "bfloat16": "bfloat16",
    "int32": "int",
    "int64": "long",
    "bool": "bool",
    "byte": "byte",
    "char": "char",
}


def _local_rank(op: CommsOp, rank: int) -> int:
    """Group-local index of a global rank (comm attrs record pg-local)."""
    ranks = op.group_ranks
    if ranks and rank in ranks:
        return ranks.index(rank)
    return rank


def _export_name(op: CommsOp, target_rank: int) -> str:
    """Collective name as written: generic ``pt2pt`` ops become the
    directional send/recv the PyTorch schema records (from
    ``target_rank``'s perspective)."""
    name = op.comms or ""
    if name == "pt2pt":
        return "send" if target_rank == op.src_rank else "recv"
    return name


def _recorded_rank(op: CommsOp, target_rank: int) -> int:
    """The rank field the parser reads at inputs[name_idx-1]: the p2p PEER
    (pg-local) for send/recv, the ROOT for rooted collectives, else 0."""
    name = _export_name(op, target_rank)
    if name in P2P_OPS:
        peer = op.dst_rank if "send" in name else op.src_rank
        return _local_rank(op, peer)
    if name in ("reduce", "gather"):
        return _local_rank(op, op.dst_rank or op.root)
    if name in ("broadcast", "scatter", "multicast"):
        return _local_rank(op, op.src_rank or op.root)
    return 0


def export_pytorch_et(
    ops: Union[Sequence[CommsOp], Sequence[Dict[str, Any]]],
    world_size: int,
    target_rank: int = 0,
    pid: Optional[int] = None,
) -> Dict[str, Any]:
    """CommsOp list (or basic-schema dict list) -> PyTorch-ET JSON dict.

    Emits one ``process_group:init`` node per distinct process group (the
    default group covers ``world_size`` ranks) and one
    ``record_param_comms`` node per comm op, comm attrs included
    (collective_name / dtype / in_msg_nelems / out_msg_nelems / splits /
    pg_name), with the (req, (pg_name, pg_desc), rank, name) input layout
    the reference parser indexes."""
    if ops and isinstance(ops[0], dict):
        ops = parse_trace(list(ops), "basic", target_rank, world_size)
    ops = [o for o in ops if o.comms and o.comms != "init"]

    # process groups: the default pg 0 plus any pg the ops reference
    pgs: Dict[int, List[int]] = {0: list(range(world_size))}
    for op in ops:
        if op.pg_id is not None and op.group_ranks:
            pgs[int(op.pg_id)] = list(op.group_ranks)

    pg_config = [
        {
            "pg_name": str(pg_id),
            "pg_desc": "default_pg" if pg_id == 0 else f"pg{pg_id}",
            "backend_config": "cpu:gloo,cuda:nccl",
            "ranks": ranks,
            "group_size": len(ranks),
            "group_count": len(pgs),
            "uid": pg_id,
        }
        for pg_id, ranks in sorted(pgs.items())
    ]

    nodes: List[Dict[str, Any]] = [
        {
            "id": 1,
            "name": "[pytorch|profiler|execution_trace|thread]",
            "ctrl_deps": 0,
            "inputs": {"values": [], "shapes": [], "types": []},
            "outputs": {"values": [], "shapes": [], "types": []},
            "attrs": [],
        },
        {
            "id": 2,
            "name": "## process_group:init ##",
            "ctrl_deps": 1,
            "inputs": {
                "values": [json.dumps(pg_config)],
                "shapes": [[]],
                "types": ["String"],
            },
            "outputs": {"values": [], "shapes": [], "types": []},
            "attrs": [],
        },
    ]

    nid = 3
    for op in ops:
        name = _export_name(op, target_rank)
        pg_id = int(op.pg_id) if op.pg_id is not None else 0
        attrs = [
            {"name": "collective_name", "type": "string", "value": name},
            {"name": "dtype", "type": "string",
             "value": _EXPORT_DTYPES.get(op.dtype, op.dtype)},
            {"name": "in_msg_nelems", "type": "uint64",
             "value": int(op.in_msg_size)},
            {"name": "out_msg_nelems", "type": "uint64",
             "value": int(op.out_msg_size)},
            {"name": "in_split_size", "type": "string",
             "value": json.dumps(list(op.in_split)) if op.in_split else "[]"},
            {"name": "out_split_size", "type": "string",
             "value": json.dumps(list(op.out_split)) if op.out_split else "[]"},
            {"name": "global_rank_start", "type": "uint64", "value": 0},
            {"name": "global_rank_stride", "type": "uint64", "value": 1},
            {"name": "pg_name", "type": "string", "value": str(pg_id)},
            {"name": "pg_size", "type": "uint64",
             "value": len(pgs.get(pg_id, [])) or (op.world_size or world_size)},
        ]
        # input layout the parser indexes relative to the name string:
        # [req, (pg_name, pg_desc), recorded_rank, name]
        values = [
            int(op.req) if op.req is not None else op.id,
            [str(pg_id), "default_pg" if pg_id == 0 else f"pg{pg_id}"],
            _recorded_rank(op, target_rank),
            name,
        ]
        nodes.append(
            {
                "id": nid,
                "name": "record_param_comms",
                "ctrl_deps": 1,
                "inputs": {
                    "values": values,
                    "shapes": [[], [[], []], [], []],
                    "types": ["Int", "Tuple[String,String]", "Int", "String"],
                },
                "outputs": {"values": [], "shapes": [], "types": []},
                "attrs": attrs,
            }
        )
        nid += 1

    return {
        "schema": SCHEMA,
        "pid": pid if pid is not None else target_rank,
        "time": "1970-01-01 00:00:00",
        "start_ts": 0,
        "nodes": nodes,
    }


def dump_pytorch_et_file(
    ops, world_size: int, path: str, target_rank: int = 0
) -> None:
    """Write the exported ET (gzip when the path ends in .gz)."""
    data = export_pytorch_et(ops, world_size, target_rank)
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "wt") as f:
            json.dump(data, f)
    else:
        with open(path, "w") as f:
            json.dump(data, f)
