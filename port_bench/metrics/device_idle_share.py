"""100 minus the share of the profiled window in which a kernel, copy or
memset ran (the union of their intervals), over the ranks."""

NAME = "device_idle_share"
UNIT = "%"
LAYER = "device (H100)"
MOVES = "samples_per_s"


def read(run):
    traces = [r["trace"] for r in run["ranks"] if r.get("trace")]
    if not traces:
        return None
    busy = sum(t["busy_us"] for t in traces)
    return 100.0 * (1.0 - busy / sum(t["window_us"] for t in traces))
