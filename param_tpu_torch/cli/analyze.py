"""Post-hoc replay analysis CLI (the port's ``param_tpu.cli.analyze``;
PARAM's ``et_replay/comm/profiler_trace_analysis.py``): per-collective
algBW / busBW of the per-rank replay details files that ``cli.replay
--output-path`` writes, and a cross-rank summary of several.

    python -m param_tpu_torch.cli.analyze details_rank0.json \\
        [details_rank1.json ...] --world-size 8
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="param_tpu_torch.analyze")
    ap.add_argument("paths", nargs="+",
                    help="per-rank replay details JSON files")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    return ap


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)

    from param_tpu_torch.trace.profiler_analysis import (
        analyze_files,
        analyze_records,
        print_summary,
    )

    if len(ns.paths) == 1:
        with open(ns.paths[0]) as f:
            result = analyze_records(json.load(f), ns.world_size)
        if ns.json:
            print(json.dumps(result, indent=2))
        else:
            print_summary(result)
    else:
        result = analyze_files(ns.paths, ns.world_size)
        print(json.dumps(result["cross_rank"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
