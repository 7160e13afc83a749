"""Message-size parsing and sweep generation (the port's own copy of
``param_tpu/utils/sizes.py``).

nccl-tests-compatible size handling, behaviorally equivalent to PARAM's
``train/comms/pt/comms_utils.py:99-253`` (``parsesize``, ``getSizes``,
``fixBeginSize``) but written as pure functions.
"""

from __future__ import annotations

import math
from typing import List, Sequence

_SUFFIX = {"K": 1024, "M": 1024**2, "G": 1024**3}


def parse_size(ipValue: str | int) -> int:
    """Parse a size string like ``"256M"``, ``"4K"``, ``"1G"`` or ``"1024"``
    into bytes.  (reference: comms_utils.py:228-253)"""
    if isinstance(ipValue, int):
        return ipValue
    s = str(ipValue).strip()
    if not s:
        raise ValueError("empty size string")
    suffix = s[-1].upper()
    if suffix in _SUFFIX:
        return int(float(s[:-1]) * _SUFFIX[suffix])
    return int(s)


def format_size(nbytes: int) -> str:
    """Human-readable size used in report tables."""
    for suffix, mult in (("G", 1024**3), ("M", 1024**2), ("K", 1024)):
        if nbytes >= mult and nbytes % mult == 0:
            return f"{nbytes // mult}{suffix}"
    return str(nbytes)


def size_sweep(
    begin: int,
    end: int,
    step_factor: int = 2,
    step_bytes: int = 0,
    *,
    elem_size: int = 4,
) -> List[int]:
    """Generate the sweep of message sizes in bytes.

    Multiplicative sweep (``step_factor``) by default, additive if
    ``step_bytes`` > 0 — matching nccl-tests ``-b/-e/-f/-i`` semantics and the
    reference's ``getSizes`` (comms_utils.py:139-165).  Every size is rounded
    down to a multiple of ``elem_size`` and de-duplicated, and ``end`` is
    always included.
    """
    if begin <= 0 or end < begin:
        raise ValueError(f"invalid sweep bounds begin={begin} end={end}")
    sizes: List[int] = []
    if step_bytes > 0:
        cur = begin
        while cur <= end:
            sizes.append(cur)
            cur += step_bytes
    else:
        if step_factor < 2:
            raise ValueError("step_factor must be >= 2")
        cur = begin
        while cur <= end:
            sizes.append(cur)
            cur *= step_factor
    out: List[int] = []
    for s in sizes:
        s = max(elem_size, (s // elem_size) * elem_size)
        if s not in out:
            out.append(s)
    if end not in out and end >= elem_size and (end // elem_size) * elem_size == end:
        out.append(end)
    return sorted(out)


def fix_begin_size(
    collective: str, begin: int, world_size: int, elem_size: int, in_split: int = 0
) -> int:
    """Clamp the begin size so every rank sends at least one element.

    For all_to_all* each rank needs >= world_size elements; for
    all_gather/gather/reduce_scatter* the aggregate buffer must hold
    world_size shards.  (reference: comms_utils.py:99-137)
    """
    c = collective
    if c in ("all_to_all", "all_to_allv", "all_to_all_single"):
        min_bytes = world_size * elem_size * max(1, in_split)
    elif c in (
        "all_gather",
        "all_gather_v",
        "gather",
        "scatter",
        "reduce_scatter",
        "reduce_scatter_v",
        "incast",
        "multicast",
    ):
        min_bytes = world_size * elem_size
    else:
        min_bytes = elem_size
    return max(begin, min_bytes)


def num_elements(size_bytes: int, elem_size: int) -> int:
    return max(1, size_bytes // elem_size)


def percentile(values: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile matching numpy's default 'linear' close enough
    for report tables; used for p50/p75/p95 latency reporting
    (reference: comms.py:1112-1149)."""
    if not values:
        return float("nan")
    vs = sorted(values)
    k = (len(vs) - 1) * (pct / 100.0)
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return vs[int(k)]
    return vs[f] * (c - k) + vs[c] * (k - f)
