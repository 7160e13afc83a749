"""What-if scaling estimator CLI (the port's ``param_tpu.cli.scaling``):
what would this trace's, or one collective's, communication cost at world
size N on H100 nodes, by the analytic model of
``param_tpu_torch.trace.scaling_model`` (PARAM hands its traces to
simulators for this).

    python -m param_tpu_torch.cli.scaling --trace-path comms.json \\
        --worlds 8 64 256
    python -m param_tpu_torch.cli.scaling --collective all_reduce \\
        --size 64M --worlds 2 4 8 16 64

A prediction, not a measurement: it runs nothing on a card.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="param_tpu_torch.scaling",
        description="analytic what-if estimator for H100 NVSwitch nodes",
    )
    ap.add_argument("--trace-path", default=None)
    ap.add_argument("--trace-type", default="basic",
                    choices=["basic", "pytorch_et", "kineto"])
    ap.add_argument("--target-rank", type=int, default=0)
    ap.add_argument("--collective", default=None,
                    help="single-collective mode (instead of a trace)")
    ap.add_argument("--size", default="64M",
                    help="per-rank payload for --collective mode")
    ap.add_argument("--generation", default="h100", choices=["h100"])
    ap.add_argument("--worlds", type=int, nargs="+",
                    default=[8, 16, 64, 256])
    ap.add_argument("--bitwidth", type=int, default=32, choices=[32, 16, 8])
    ap.add_argument("--nvlink-gbs", type=float, default=None,
                    help="override the one-way GB/s of each ring direction "
                         "of a GPU in a node (half its NVLink rate)")
    ap.add_argument("--dcn-gbs-per-host", type=float, default=None,
                    help="override a node's one-way inter-node GB/s")
    ap.add_argument("--hop-latency-us", type=float, default=None)
    ap.add_argument("--json", action="store_true")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    from param_tpu_torch.trace.scaling_model import (
        format_report,
        predict_collective_us,
        predict_worlds,
        predicted_bus_bw,
        slice_topology,
    )

    topo_kw = dict(
        link_gbs=ns.nvlink_gbs,
        dcn_gbs_per_host=ns.dcn_gbs_per_host,
        hop_latency_us=ns.hop_latency_us,
    )

    if ns.collective:
        from param_tpu_torch.utils.sizes import parse_size

        size = parse_size(ns.size)
        rows = []
        for w in ns.worlds:
            topo = slice_topology(ns.generation, w, **topo_kw)
            t = predict_collective_us(ns.collective, size, topo, ns.bitwidth)
            rows.append({
                "world": w,
                "nodes": topo.layout(),
                "time_us": round(t, 2),
                "bus_bw_gbs": round(predicted_bus_bw(
                    ns.collective, size, topo, ns.bitwidth), 2),
            })
        if ns.json:
            print(json.dumps(rows, indent=2))
        else:
            print(f"# {ns.collective} size={ns.size} gen={ns.generation} "
                  f"bitwidth={ns.bitwidth}")
            print(f"{'world':>6} {'nodes':>14} {'time us':>12} "
                  f"{'busBW GB/s':>12}")
            for r in rows:
                print(f"{r['world']:>6} {r['nodes']:>14} "
                      f"{r['time_us']:>12.2f} {r['bus_bw_gbs']:>12.2f}")
        return 0

    if not ns.trace_path:
        print("error: provide --trace-path or --collective", file=sys.stderr)
        return 2

    from param_tpu_torch.trace.comms_trace import parse_trace, read_trace_file

    raw = read_trace_file(ns.trace_path)
    ops = parse_trace(raw, ns.trace_type, target_rank=ns.target_rank)
    preds = predict_worlds(ops, ns.generation, ns.worlds,
                           bitwidth=ns.bitwidth, **topo_kw)
    if ns.json:
        print(json.dumps([p.row() for p in preds], indent=2))
    else:
        print(f"# trace={ns.trace_path} gen={ns.generation} "
              f"bitwidth={ns.bitwidth}")
        print(format_report(preds))
        # per-op breakdown at the first world
        p0 = preds[0]
        print(f"\n# per-op breakdown at world={p0.topo.n_gpus}")
        for name, agg in sorted(p0.per_op.items()):
            print(f"  {name:<16} n={agg.count:<5} "
                  f"{agg.size_bytes/1e6:>10.2f} MB "
                  f"{agg.time_us/1e3:>10.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
