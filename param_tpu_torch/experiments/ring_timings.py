"""The ring kernels on one card at their main-path sizes, for comparing two
checkouts in one call.

K8d (the loopback: the neighbour barrier, the copy, the ready flag) and
the kernel K8a-c take over one rank (a plain copy) do the same copy, so
their difference is K8d's handshake; the copy kernel against one
``X.clone()`` (a ``cudaMemcpyAsync``) is the copy loop against
CUDA's own.  Those three are timed
at n = 1, 64 MiB and 1 MiB f32, and K8d also with 2, 4 and 8 ranks on the
card, at 64 MiB and 1 MiB.  K8c and K8a, which move the same bytes, are
timed at n = 8, 64 MiB f32 a rank, and K8c also at n 2, 3 and 4 and at 1
MiB; K8b at n = 8, 64 MiB on both its routes.  Every row is timed from
CUDA-graph replays (median and spread of 5 windows) after its result is
held to its plain ring, byte for byte (K8b's sums too).  One JSON line
per row, with the plan, the bound (bytes over 3.35 TB/s) and the card's
name and power limit.

    python -m param_tpu_torch.experiments.ring_timings

It calls only the wrappers, their plain versions, ``launch_plan`` and
``forced_route``, so another checkout's package is timed by the same
script in the same call: ``PYTHONPATH=. python <this file>`` from inside
that checkout.
"""

from __future__ import annotations

import contextlib
import json
import statistics

import torch

from param_tpu_torch.kernels import ring
from param_tpu_torch.utils.chip import bound_ms, nvidia_smi_name_power
from param_tpu_torch.utils.timer import time_samples

MIB = 1 << 20
# (row, kernel, ranks, bytes a rank, K8b's route): "copy" is K8a over one
# rank, "clone" X.clone()
CASES = [("K8d", "loopback", 1, 64 * MIB, None),
         ("copy", "all_gather", 1, 64 * MIB, None),
         ("clone", None, 1, 64 * MIB, None),
         ("K8d", "loopback", 1, MIB, None),
         ("copy", "all_gather", 1, MIB, None),
         ("clone", None, 1, MIB, None),
         ("K8d", "loopback", 2, 64 * MIB, None),
         ("K8d", "loopback", 4, 64 * MIB, None),
         ("K8d", "loopback", 8, 64 * MIB, None),
         ("K8d", "loopback", 2, MIB, None),
         ("K8d", "loopback", 4, MIB, None),
         ("K8d", "loopback", 8, MIB, None),
         ("K8c", "bidir", 8, 64 * MIB, None),
         ("K8a", "all_gather", 8, 64 * MIB, None),
         ("K8c", "bidir", 4, 64 * MIB, None),
         ("K8c", "bidir", 3, 64 * MIB, None),
         ("K8c", "bidir", 2, 64 * MIB, None),
         ("K8c", "bidir", 2, MIB, None),
         ("K8c", "bidir", 4, MIB, None),
         ("K8c", "bidir", 8, MIB, None),
         ("K8b", "reduce_scatter", 8, 64 * MIB, "cluster"),
         ("K8b", "reduce_scatter", 8, 64 * MIB, "memory")]
WRAPPERS = {"loopback": (ring.ring_loopback_cuda, ring.ring_loopback_plain),
            "all_gather": (ring.ring_all_gather_cuda,
                           ring.ring_all_gather_plain),
            "bidir": (ring.ring_all_gather_bidir_cuda,
                      ring.ring_all_gather_bidir_plain),
            "reduce_scatter": (ring.ring_reduce_scatter_cuda,
                               ring.ring_reduce_scatter_plain)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ring_timings: needs an NVIDIA GPU (it times the "
                         "card's kernels)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = nvidia_smi_name_power(0)
    for row, kind, n, nbytes, route in CASES:
        xs = [torch.randn(nbytes // 4, generator=gen, device=dev)
              for _ in range(n)]
        rec = dict(row=row, n=n, mib=nbytes / MIB, dtype="float32",
                   card=smi)
        with (ring.forced_route(route) if route
              else contextlib.nullcontext()):
            if kind is None:
                call = xs[0].clone
                moved = 2 * nbytes
            else:
                cuda_fn, plain_fn = WRAPPERS[kind]
                got, want = cuda_fn(xs), plain_fn(xs)
                rec["equal"] = all(torch.equal(g, w)
                                   for g, w in zip(got, want))
                chunk = nbytes // n if kind == "reduce_scatter" else nbytes
                rec["plan"] = ring.launch_plan(kind, xs, chunk).text()
                call = lambda: cuda_fn(xs, check=False)  # noqa: E731
                # inputs read once, outputs written once
                moved = (n * nbytes + nbytes if kind == "reduce_scatter"
                         else n * nbytes * (2 if kind == "loopback" or n == 1
                                            else 1 + n))
                del got, want
            iters = 20 if n * nbytes <= 64 * MIB else 3
            t = time_samples(call, iters, reps=5, graph=True)
        if kind is not None:
            ring.check_errors(xs)  # no bounded wait ran out while timing
        rec.update(ms=statistics.median(t), ms_min=min(t), ms_max=max(t),
                   bound_ms=bound_ms(moved)[0],
                   tb_s=moved / statistics.median(t) / 1e9)
        if route:
            rec["route"] = route
        print(json.dumps(rec), flush=True)
        del xs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
