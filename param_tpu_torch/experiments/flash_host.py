"""Host cost of an eager K6 / K7 call beside the card's time for it.

An eager call of the flash kernels pays, on the host, the wrapper's checks,
the output allocations, the path choice, the encoding of the tensor maps
(wgmma path) and the launch; the card pays the kernels.  For the attention
benches' shapes (ATTN_LLAMA2's first row causal, ATTN_GPT2's batch-8 row)
and for the llama2 train step's views (q, k, v strided heads of one (1,
2048, 3 x 4096) projection, dO a transposed-head view), bf16, this prints
one JSON line per kernel and shape: the host's microseconds a call
(``perf_counter`` around back-to-back eager calls, whose launches queue
without waiting for the card; median of 9 windows of 50), the card's ms
a call (CUDA-graph replays, median of 5 windows), and the card's name and
power limit.

    python -m param_tpu_torch.experiments.flash_host

It calls only ``flash_fwd_cuda`` and ``flash_bwd_cuda``, so another
checkout's package can be timed by the same script in the same call:
``PYTHONPATH=<checkout> python param_tpu_torch/experiments/flash_host.py``
from inside that checkout.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from param_tpu_torch.kernels.flash_bwd import flash_bwd_cuda
from param_tpu_torch.kernels.flash_fwd import flash_fwd_cuda
from param_tpu_torch.utils.chip import nvidia_smi_name_power
from param_tpu_torch.utils.timer import time_samples

# (name, (B, H, S, D), causal, fused): fused takes q, k, v as head views of
# one (B, S, 3 H D) projection and dO as a transposed-head view
CASES = [("llama2", (1, 32, 2048, 128), True, False),
         ("gpt2", (8, 12, 1024, 64), False, False),
         ("llama2 train-step views", (1, 32, 2048, 128), True, True)]
# eager calls in a window timed on the host clock, and windows (the median
# is printed)
CALLS, WINDOWS = 50, 9


def host_us(fn, calls: int, windows: int) -> float:
    """Host microseconds a call of ``fn``: the median over ``windows`` of
    ``calls`` back-to-back eager calls each (few enough that their launches
    fit the card's queue), after a warm-up; the card catches up between
    windows, untimed."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(out)


def inputs(shape, fused, gen, dev):
    b, h, s, d = shape
    if fused:
        y = torch.randn((b, s, 3 * h * d), generator=gen, device=dev)
        q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
                   for t in y.bfloat16().split(h * d, dim=-1))
        do = torch.randn((b, s, h * d), generator=gen, device=dev)
        do = do.bfloat16().reshape(b, s, h, d).transpose(1, 2)
    else:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .bfloat16() for _ in range(4))
    return q, k, v, do


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_host: needs an NVIDIA GPU (it times the "
                         "card's kernels)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = nvidia_smi_name_power(0)
    for name, shape, causal, fused in CASES:
        q, k, v, do = inputs(shape, fused, gen, dev)
        o, lse = flash_fwd_cuda(q, k, v, causal, None, None, True)
        calls = {
            "K6": lambda: flash_fwd_cuda(q, k, v, causal, None, None, True),
            "K7": lambda: flash_bwd_cuda(q, k, v, o, lse, do, causal)}
        for kernel, fn in calls.items():
            card = time_samples(fn, 20, reps=5, graph=True)
            print(json.dumps({
                "kernel": kernel, "case": name, "shape": list(shape),
                "causal": causal,
                "host_us": host_us(fn, CALLS, WINDOWS),
                "card_ms": statistics.median(card), "card": smi}),
                flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
