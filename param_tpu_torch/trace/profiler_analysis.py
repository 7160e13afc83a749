"""Post-hoc replay / trace bandwidth analysis (the port's
``param_tpu/trace/profiler_analysis.py``; PARAM's
``et_replay/comm/profiler_trace_analysis.py``: per-collective algBW/busBW
with nccl-tests correction factors :85-118, uneven all_to_all handling via
max(send, recv) excluding the self-rank slice :181-225, shared bandwidth
:271, iteration e2e time, cross-rank summary :485).

Input: the per-op replay details produced by ``CommsReplay.write_details``
(one JSON list per rank) or in-memory ``OpRecord`` lists.  The busBW factor
table is shared with the live benches (utils.bw) — the reference duplicated
it; here there is one copy.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from param_tpu_torch.utils.bw import alg_bw, bus_bw_factor
from param_tpu_torch.utils.sizes import percentile


@dataclass
class CollectiveSummary:
    count: int = 0
    total_bytes: int = 0
    total_us: float = 0.0
    lat_us: List[float] = field(default_factory=list)
    sizes: List[int] = field(default_factory=list)

    def row(self, name: str, world: int) -> Dict:
        p50_lat = percentile(self.lat_us, 50)
        p50_size = percentile(self.sizes, 50) if self.sizes else 0
        abw = alg_bw(int(p50_size), p50_lat) if p50_lat else 0.0
        return {
            "collective": name,
            "count": self.count,
            "total_bytes": self.total_bytes,
            "p50_us": p50_lat,
            "p95_us": percentile(self.lat_us, 95),
            "alg_bw_gbs": abw,
            "bus_bw_gbs": abw * bus_bw_factor(name, world),
        }


def effective_a2a_bytes(
    in_split: Sequence[int], out_split: Sequence[int], rank: int, elem: int
) -> int:
    """Uneven all_to_all payload: max(sent, received) excluding the
    self-rank slice (reference: profiler_trace_analysis.py:181-225)."""
    sent = sum(s for i, s in enumerate(in_split) if i != rank)
    recv = sum(s for i, s in enumerate(out_split) if i != rank)
    return max(sent, recv) * elem


def analyze_records(
    records: List[Dict], world_size: int, rank: int = 0
) -> Dict:
    """records: list of per-op dicts with keys comms/size_bytes/lat_us
    (the write_details schema).  Returns the per-collective summary plus
    shared-bandwidth and e2e totals."""
    per: Dict[str, CollectiveSummary] = defaultdict(CollectiveSummary)
    total_us = 0.0
    total_bytes = 0
    for r in records:
        name = r["comms"]
        if name.startswith("compute:"):
            continue
        s = per[name]
        nbytes = r.get("size_bytes", 0)
        lat = r.get("lat_us", 0.0)
        s.count += 1
        s.total_bytes += nbytes
        s.total_us += lat
        s.lat_us.append(lat)
        s.sizes.append(nbytes)
        total_us += lat
        total_bytes += nbytes
    rows = [s.row(name, world_size) for name, s in sorted(per.items())]
    # shared bandwidth: all comm bytes over all comm time
    # (reference: calculate_sbw:271)
    sbw = alg_bw(total_bytes, total_us) if total_us else 0.0
    return {
        "world_size": world_size,
        "rank": rank,
        "collectives": rows,
        "shared_bw_gbs": sbw,
        "total_comm_us": total_us,
        "total_comm_bytes": total_bytes,
    }


def analyze_files(paths: Sequence[str], world_size: int) -> Dict:
    """Cross-rank summary from per-rank details files
    (reference: summarize_profiler_trace:485)."""
    per_rank = []
    for rank, p in enumerate(paths):
        with open(p) as f:
            per_rank.append(analyze_records(json.load(f), world_size, rank))
    agg: Dict[str, Dict] = {}
    for r in per_rank:
        for row in r["collectives"]:
            name = row["collective"]
            a = agg.setdefault(
                name,
                {"collective": name, "count": 0, "total_bytes": 0,
                 "p50_us": [], "bus_bw_gbs": []},
            )
            a["count"] += row["count"]
            a["total_bytes"] += row["total_bytes"]
            a["p50_us"].append(row["p50_us"])
            a["bus_bw_gbs"].append(row["bus_bw_gbs"])
    for a in agg.values():
        a["p50_us"] = percentile(a["p50_us"], 50)
        a["bus_bw_gbs"] = percentile(a["bus_bw_gbs"], 50)
    return {
        "num_ranks": len(per_rank),
        "per_rank": per_rank,
        "cross_rank": sorted(agg.values(), key=lambda a: a["collective"]),
    }


def print_summary(result: Dict) -> None:
    print(f"{'collective':>16}{'count':>8}{'bytes':>14}{'p50(us)':>12}"
          f"{'algBW(GB/s)':>13}{'busBW(GB/s)':>13}")
    for row in result["collectives"]:
        print(
            f"{row['collective']:>16}{row['count']:>8}{row['total_bytes']:>14}"
            f"{row['p50_us']:>12.1f}{row['alg_bw_gbs']:>13.2f}"
            f"{row['bus_bw_gbs']:>13.2f}"
        )
    print(f"shared BW: {result['shared_bw_gbs']:.2f} GB/s  "
          f"total comm: {result['total_comm_us']:.0f} us / "
          f"{result['total_comm_bytes']} bytes")
