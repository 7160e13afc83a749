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

``--bitwidth 16|8`` quantizes the sum all_reduce / reduce (and casts the
other quantizable collectives' payload); ``--backend`` takes ``dist``,
``torchcomms`` (the communicator facade over it) or ``mock`` (no-op
collectives on CPU tensors, no process group); ``--trace-dump PATH``
records every collective call as a basic-schema comm trace and
``--trace-dump-et PATH`` exports it as a PyTorch ET (rank 0 writes them);
with ``--profile DIR`` and a bitwidth, rank 0 prints the comm / quant /
dequant / other split of the card's time.

Not ported (NotImplementedError): the reference's single-controller
``--num-devices``, ``--coordinator``, ``--num-processes`` and
``--process-id`` (torchrun sets the world).
"""

from __future__ import annotations

import argparse
import logging
import sys

from param_tpu_torch.backend.base import PT2PT_PATTERNS, REDUCE_OPS


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
    ap.add_argument("--pt2pt", default=None, choices=[None, *PT2PT_PATTERNS])
    ap.add_argument("--window", type=int, default=100, help="pt2pt BW window size")
    ap.add_argument("--bitwidth", type=int, default=32,
                    help="quantized comm bitwidth (16/8)")
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
                    choices=["dist", "torchcomms", "mock"],
                    help="dist: torch.distributed; torchcomms: every "
                         "collective through the communicator facade "
                         "(quantized all_reduce / reduce through dist); "
                         "mock: no-op collectives, no process group")
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
                    help="record every collective as a basic-schema comm "
                         "trace (replayable with cli.replay)")
    ap.add_argument("--trace-dump-et", default=None, metavar="PATH",
                    help="also export the recorded trace in the PyTorch-ET "
                         "(Chakra host ET) schema")
    ap.add_argument("--output-json", default=None, metavar="PATH",
                    help="append metric records as JSON lines")
    ap.add_argument("--n-per-iter", type=int, default=1,
                    help="collective posts per timed iteration")
    ap.add_argument("--log", default="INFO")
    ap.add_argument("--list", action="store_true", help="list collectives and exit")
    return ap


def _refuse_unported(ns) -> None:
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

    cls = get_backend_cls(ns.backend)
    backend = cls() if ns.backend == "mock" else cls(ns.device)
    backend.initialize()
    try:
        bench = CollBench(backend, params, reps=ns.reps)
        if ns.output_json:
            perf_log.register_perf_logger(
                "comms-file", perf_log.FileJsonLogger(ns.output_json))
        rank0 = backend.get_global_rank() == 0
        dev = backend.get_device()
        if rank0:
            wire = ("none" if ns.backend == "mock" else
                    "nccl" if dev.type == "cuda" else "gloo")
            print(f"comms: world {backend.get_world_size()} on {dev} "
                  f"({ns.backend}, {wire}), mode {params.mode.value}"
                  + (f", bitwidth {params.bitwidth}"
                     if params.bitwidth != 32 else ""))
        if ns.trace_dump or ns.trace_dump_et:
            backend.start_trace_recording()
        if ns.size_start_profiler and ns.profile:
            bench.profiler = SizeTriggeredProfiler(
                ns.profile, parse_size(ns.size_start_profiler), dev)
            try:
                backend.benchmark_comms(bench.run)
            finally:
                bench.profiler.stop()
        else:
            with profile_to(ns.profile, dev):
                backend.benchmark_comms(bench.run)
        if ns.trace_dump or ns.trace_dump_et:
            _dump_trace(backend.stop_trace_recording(), backend, ns, rank0)
        if ns.profile and ns.bitwidth != 32 and rank0:
            _print_quant_split(ns.profile, dev)
    finally:
        perf_log.unregister_perf_logger("comms-file")
        backend.shutdown()
    return 0


def _dump_trace(trace, backend, ns, rank0: bool) -> None:
    """Rank 0 writes the recorded trace (its own calls; every rank of a
    sweep makes the same ones)."""
    if not rank0:
        return
    if ns.trace_dump:
        from param_tpu_torch.trace.comms_trace import dump_trace_file

        dump_trace_file(trace, ns.trace_dump)
        print(f"recorded {len(trace)} comm ops -> {ns.trace_dump}")
    if ns.trace_dump_et:
        from param_tpu_torch.trace.export_pytorch_et import (
            dump_pytorch_et_file,
        )

        dump_pytorch_et_file(trace, backend.get_world_size(),
                             ns.trace_dump_et)
        print(f"exported {len(trace)} comm ops as PyTorch-ET -> "
              f"{ns.trace_dump_et}")


def _print_quant_split(profile_dir: str, dev) -> None:
    """The card's time in the profiled sweep: comm (NCCL kernels), quant,
    dequant (kernels under those record_function regions) and other."""
    if dev.type != "cuda":
        print("quantized device-time split: CPU run, not measured")
        return
    from param_tpu_torch.trace.device_trace import (
        load_chrome_trace, quant_comm_split,
    )

    events, threads = load_chrome_trace(profile_dir)
    split = quant_comm_split(events, threads)
    total = sum(d["total_us"] for d in split.values()) or 1.0
    print("quantized device-time split (from profile):")
    for k in ("comm", "quant", "dequant", "other"):
        d = split[k]
        print(f"  {k:>8}: {d['total_us']:>10.1f} us "
              f"({100 * d['total_us'] / total:5.1f}%)  n={d['count']}")


if __name__ == "__main__":
    sys.exit(main())
