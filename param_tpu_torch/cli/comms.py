"""CLI for the collective sweep benchmark (the port's ``param_tpu.cli.comms``;
flags after PARAM's ``comms.py``: ``--b/--e/--f/--i/--n/--w`` nccl-tests
sizing, ``--collective`` (a comma list), ``--z`` blocking mode, ``--c`` data
check, ``--pt2pt`` patterns, ``--multi-comms``).

One process per rank, launched by torchrun; without torchrun the process
is a world of one.  On the card the ranks talk through NCCL (one card per
rank: ``LOCAL_RANK``), with ``--device cpu`` through gloo.  The ``--``
after the module name keeps torchrun's own parser off the flags (recent
torchrun takes ``--e`` as an abbreviation of its ``--event-log-handler``);
a leading ``--`` is dropped here:

    torchrun --nproc-per-node 8 -m param_tpu_torch.cli.comms -- \\
        --collective all_reduce --b 8 --e 64M --c 1
    torchrun --nproc-per-node 2 -m param_tpu_torch.cli.comms -- --device cpu \\
        --collective all_reduce,all_gather --b 1K --e 64K --c 1

Not ported (they raise NotImplementedError naming their ROADMAP item):
``--bitwidth`` other than 32, ``--trace-dump`` / ``--trace-dump-et``,
``--backend`` other than ``dist``, and the reference's single-controller
``--num-devices``, ``--coordinator``, ``--num-processes`` and
``--process-id`` (torchrun sets the world).
"""

from __future__ import annotations

import argparse
import logging
import sys

from param_tpu_torch.backend.base import REDUCE_OPS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="param_tpu_torch.comms",
        description="PARAM collective benchmark on torch.distributed")
    ap.add_argument("--collective", "--coll", default="all_reduce",
                    help="comma-separated collectives (see --list)")
    ap.add_argument("--b", default="8", help="begin size (nccl-tests style)")
    ap.add_argument("--e", default="64M", help="end size")
    ap.add_argument("--f", type=int, default=2, help="multiplicative step factor")
    ap.add_argument("--i", default=None, help="additive step bytes (overrides --f)")
    ap.add_argument("--ss", default=None, help="explicit comma list of sizes")
    ap.add_argument("--n", type=int, default=20, help="timed iterations")
    ap.add_argument("--w", type=int, default=2, help="warmup iterations")
    ap.add_argument("--data-type", default="float32")
    ap.add_argument("--mode", default="dispatch",
                    choices=["dispatch", "blocking", "graph"],
                    help="timing mode: windows of eager calls timed with "
                         "CUDA events (dispatch), each call to completion "
                         "on the host clock (blocking == --z 1), or windows "
                         "replayed from a CUDA graph (graph)")
    ap.add_argument("--z", type=int, default=None,
                    help="reference compat: 1 -> blocking mode")
    ap.add_argument("--c", type=int, default=0, help="data validation (dcheck)")
    ap.add_argument("--reduce-op", default="sum", choices=REDUCE_OPS)
    ap.add_argument("--src-rank", "--root", type=int, default=0)
    ap.add_argument("--dst-rank", type=int, default=0)
    ap.add_argument("--src-ranks", default="", help="comma ranks for incast/pt2pt")
    ap.add_argument("--dst-ranks", default="", help="comma ranks for multicast/pt2pt")
    ap.add_argument("--pt2pt", default=None, choices=[None, "one2one", "pairwise"])
    ap.add_argument("--window", type=int, default=100, help="pt2pt BW window size")
    ap.add_argument("--bitwidth", type=int, default=32,
                    help="quantized comm bitwidth (not ported: 32 only)")
    ap.add_argument("--multi-comms", type=int, default=1,
                    help="round-robin ranks into N groups")
    ap.add_argument("--in-split", default=None,
                    help="comma per-rank element counts for all_to_allv")
    ap.add_argument("--out-split", default=None,
                    help="comma per-rank element counts for reduce_scatter_v")
    ap.add_argument("--tag", default="", help="tag attached to metric records")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="not ported: torchrun sets the world")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="not ported: torchrun sets the world")
    ap.add_argument("--process-id", type=int, default=None,
                    help="not ported: torchrun sets the world")
    ap.add_argument("--backend", default="dist",
                    help="registered backend name (dist: torch.distributed)")
    ap.add_argument("--num-devices", type=int, default=0,
                    help="not ported: torchrun sets the world")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank) or cpu (gloo)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed windows per point (at least 10 are taken)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the sweep with torch.profiler into DIR")
    ap.add_argument("--size-start-profiler", default=None, metavar="SIZE",
                    help="start the profiler only once the sweep reaches "
                         "this message size")
    ap.add_argument("--trace-dump", default=None, metavar="PATH",
                    help="not ported: record the collectives as a comm trace")
    ap.add_argument("--trace-dump-et", default=None, metavar="PATH",
                    help="not ported: export the trace as PyTorch-ET")
    ap.add_argument("--output-json", default=None, metavar="PATH",
                    help="append metric records as JSON lines")
    ap.add_argument("--n-per-iter", type=int, default=1,
                    help="collective posts per timed iteration")
    ap.add_argument("--log", default="INFO")
    ap.add_argument("--list", action="store_true", help="list collectives and exit")
    return ap


def _refuse_unported(ns) -> None:
    if ns.bitwidth != 32:
        raise NotImplementedError(
            "--bitwidth other than 32: quantized collectives come with "
            "comms/quantization.py, ROADMAP item 10")
    if ns.trace_dump or ns.trace_dump_et:
        raise NotImplementedError(
            "--trace-dump / --trace-dump-et: the comm trace comes with the "
            "trace tier, ROADMAP item 11")
    if ns.backend != "dist":
        raise NotImplementedError(
            f"--backend {ns.backend!r}: the port has the torch.distributed "
            f"backend only; mock_backend and torchcomms are ROADMAP item 10")
    if ns.num_devices or ns.coordinator or ns.num_processes is not None \
            or ns.process_id is not None:
        raise NotImplementedError(
            "--num-devices / --coordinator / --num-processes / --process-id "
            "belong to the reference's single controller; the port runs one "
            "process per rank and torchrun sets the world (ROADMAP, "
            "deliberate leave-outs)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--"]:  # what torchrun passes on after ``-m ... --``
        argv = argv[1:]
    ns = build_parser().parse_args(argv)
    logging.basicConfig(
        level=ns.log.upper(),
        format="[%(asctime)s %(levelname)s] %(name)s: %(message)s")
    from param_tpu_torch.backend import SUPPORTED_COLLECTIVES, get_backend_cls
    from param_tpu_torch.comms.coll_bench import CollBench
    from param_tpu_torch.comms.harness import CommsParams
    from param_tpu_torch.utils import logger as perf_log
    from param_tpu_torch.utils.profiler import (
        SizeTriggeredProfiler, profile_to,
    )
    from param_tpu_torch.utils.sizes import parse_size

    if ns.list:
        print("\n".join(SUPPORTED_COLLECTIVES))
        return 0
    _refuse_unported(ns)
    if ns.z == 1:
        ns.mode = "blocking"
    params = CommsParams.from_args(ns)
    params.num_coll_per_iter = ns.n_per_iter

    backend = get_backend_cls(ns.backend)(ns.device)
    backend.initialize()
    try:
        bench = CollBench(backend, params, reps=ns.reps)
        if ns.output_json:
            perf_log.register_perf_logger(
                "comms-file", perf_log.FileJsonLogger(ns.output_json))
        if backend.get_global_rank() == 0:
            dev = backend.get_device()
            print(f"comms: world {backend.get_world_size()} on {dev} "
                  f"({'nccl' if dev.type == 'cuda' else 'gloo'}), "
                  f"mode {params.mode.value}")
        if ns.size_start_profiler and ns.profile:
            bench.profiler = SizeTriggeredProfiler(
                ns.profile, parse_size(ns.size_start_profiler),
                backend.get_device())
            try:
                backend.benchmark_comms(bench.run)
            finally:
                bench.profiler.stop()
        else:
            with profile_to(ns.profile, backend.get_device()):
                backend.benchmark_comms(bench.run)
    finally:
        perf_log.unregister_perf_logger("comms-file")
        backend.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
