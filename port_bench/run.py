"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads/<cell>.json``) names a configuration and a traffic mix
(``spec.py``).  On one card the run happens in this process; on four it
starts one process a card (``torch.multiprocessing``, spawn), joined by NCCL
through ``tcp://localhost`` on a free port, and this process gathers their
results.  Once the window has closed and the program's state is freed, the
plain reference of the configuration's model family (``models/<model>.py``)
follows the checked steps on card 0 and ``check.py`` decides ``correct``.  With ``--trace 0`` the line carries the
cell's end-to-end metrics (``end_to_end/``), with ``--trace 1`` its
per-layer metrics (``metrics/``), read from the profiler's trace of a steady
part of the window.  A run on a machine without the cards the cell asks
for fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# every cache the program or torch may write, at fixed paths in the checkout
_CACHE = os.path.join(_ROOT, ".port_bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(_CACHE, "inductor")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
os.environ.setdefault("OMP_NUM_THREADS", "1")

from port_bench import check, spec  # noqa: E402

DEADLINE_S = 330  # the rank processes' share of a run's 360 seconds


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="port_bench.run", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, job, queue, device_type):
    """One rank's process: its card, the process group, a
    ``param_tpu_torch.backend.DistBackend`` on it, then
    ``job(rank, world, group, device, agree)``, whose result (or error)
    goes to ``queue``.  ``agree(x)`` is the largest x over the ranks."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            kw = {"device_id": device}
        else:
            device = torch.device("cpu")
            kw = {}
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world, **kw)
        from param_tpu_torch.backend import DistBackend

        backend = DistBackend(device_type)
        backend.initialize()  # takes the group made above
        group = backend.get_default_group()

        def agree(x: float) -> float:
            t = torch.tensor([x], dtype=torch.float64, device=device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return float(t)

        out = job(rank, world, group, device, agree)
        agree(0.0)  # every rank done before the group goes
        backend.shutdown()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # the parent reports it and fails the run
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def run_ranks(chips: int, job, device_type: str = "cuda",
              deadline_s: float = DEADLINE_S) -> list:
    """``job``'s result on every rank, in rank order, from one process a
    rank; every process has ended when this returns."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, chips, port, job, q, device_type))
             for r in range(chips)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + deadline_s
    try:
        while len(results) < chips:
            try:
                rank, out = q.get(timeout=5)
            except queue_mod.Empty:
                if time.time() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank process failed or timed out")
                continue
            if isinstance(out, dict) and "error" in out:
                raise RuntimeError(f"rank {rank} failed:\n{out['error']}")
            results[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(chips)]


def run_cell(cell, seed: int, seconds: float, traced: bool,
             device_type: str = "cuda", rank_job=None) -> dict:
    """The cell's run on this machine: the ranks' results and the checked
    readings against the reference.  ``device_type`` "cpu" exercises the
    harness on the port's plain paths, and ``rank_job`` stands in for
    :func:`worker.run_rank` (tests); neither times anything."""
    import torch

    from port_bench import worker

    rank_job = rank_job or worker.run_rank
    device = (torch.device("cuda", 0) if device_type == "cuda"
              else torch.device("cpu"))
    if cell.chips == 1:
        ranks = [rank_job(cell, seed, seconds, traced, 0, 1, None, device)]
        # the program's state went with run_rank's frame
        if device_type == "cuda":
            torch.cuda.empty_cache()
    else:
        job = functools.partial(rank_job, cell, seed, seconds, traced)
        ranks = run_ranks(cell.chips, job, device_type)
    t_ref = time.time()
    ref = spec.model(cell.config["model"]).reference_readings(
        cell.config, cell.traffic, seed, cell.chips, device)
    prog = check.merge([r["readings"] for r in ranks])
    values = check.gaps(prog, ref)
    return {"ranks": ranks, "values": values, "reference_s": time.time() - t_ref}


def result_line(cell, run: dict, traced: bool, device_info: dict) -> dict:
    """The contract's result: metrics read by the cell's reader modules."""
    ranks = run["ranks"]
    context = {"cell": cell, "ranks": ranks, "t_start": T_START}
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for mod in spec.metrics(kind, cell.name):
        value = mod.read(context)
        if value is not None:
            metrics[mod.NAME] = {"value": value, "unit": mod.UNIT}
    failed = sum(r["nonfinite"] for r in ranks)
    values = run["values"]
    limits = cell.limits
    device = dict(device_info)
    device["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in ranks)
    line = {"correct": check.verdict(values, limits) and failed == 0,
            "attempted": ranks[0]["n_steps"],
            "failed": failed, "metrics": metrics, "device": device}
    traces = [r["trace"] for r in ranks if r.get("trace")]
    if traced and traces:
        device["busy_s"] = sum(t["busy_us"] for t in traces) / len(traces) / 1e6
        device["window_s"] = (sum(t["window_us"] for t in traces)
                              / len(traces) / 1e6)
        lead = traces[0]
        line["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in lead["device_ops"]],
            "idle_gaps": [[n, us / 1e6] for n, us in lead["idle_gaps"]]}
    # a reading that is not finite (a loss gone NaN) prints as the largest
    # float, which no limit admits
    line["checks"] = {k: {"value": min(values[k], sys.float_info.max),
                          "limit": limits[k]} for k in check.NAMES}
    return line


def setup_parts(ranks: list) -> str:
    """Where set-up went on each rank, in seconds from process start: to the
    rank's start (imports, CUDA, on several cards the processes and the
    group), the program built, its checked steps, warm-up."""
    parts = []
    for r, out in enumerate(ranks):
        m = out["setup_marks"]
        parts.append(f"rank {r} " + " ".join(
            f"{k} {m[k] - T_START:.2f}" for k in m))
        parts[-1] += f" window {out['t_window_start'] - T_START:.2f}"
    return "setup s: " + "; ".join(parts)


def main(argv=None) -> int:
    ns = parse(argv)
    cell = spec.cell(ns.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from port_bench.worker import forbidden_modules

    run = run_cell(cell, ns.seed, ns.seconds, bool(ns.trace))
    found = sorted(set(m for r in run["ranks"] for m in r["forbidden"])
                   | set(forbidden_modules()))
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    line = result_line(cell, run, bool(ns.trace), info)
    print(setup_parts(run["ranks"]), file=sys.stderr)
    print(f"reference {run['reference_s']:.1f} s", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
