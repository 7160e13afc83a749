"""K6 and K7 in f32 at the attention CLIs' widths, beside SDPA's f32 calls.

For the f32 shapes of ``cli.compute attention --dtype float32`` (ATTN_LLAMA2's
first row, causal; ATTN_GPT2's batch-8 row, not causal) and the small
causal (1, 4, 512, 64), this prints one JSON line per kernel and shape: the
path whose launch counter moved, the card's ms a call (CUDA-graph replays,
median and spread of 5 windows), SDPA's f32 call timed the same way
(forward) or through autograd by ``torch.profiler`` (backward, with K7
timed that way too, and each one's kernels by name), K6's largest error
against its plain version, and the card's name and power limit.

    python -m param_tpu_torch.experiments.flash_f32

It calls only the wrappers ``flash_fwd_cuda``, ``flash_bwd_cuda`` and
``flash_fwd_plain`` and the launch counters, so another checkout's package
is timed by the same script in the same call:
``PYTHONPATH=. python <this file>`` from inside that checkout.
"""

from __future__ import annotations

import json
import statistics

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from param_tpu_torch import kernels
from param_tpu_torch.kernels.flash_bwd import flash_bwd_cuda
from param_tpu_torch.kernels.flash_fwd import flash_fwd_cuda, flash_fwd_plain
from param_tpu_torch.utils.chip import nvidia_smi_name_power
from param_tpu_torch.utils.timer import time_samples

# (name, (B, H, S, D), causal)
CASES = [("llama2", (1, 32, 2048, 128), True),
         ("gpt2", (8, 12, 1024, 64), False),
         ("small", (1, 4, 512, 64), True)]


def moved_path(kernel: str, fn):
    """fn() and the path of ``kernel`` whose launch counter it moved."""
    before = dict(kernels.launch_counts)
    out = fn()
    moved = [k[len(kernel) + 1:] for k, n in kernels.launch_counts.items()
             if k.startswith(kernel + "_") and n != before.get(k)]
    return out, ",".join(moved)


def profiled_ms(run, calls: int = 10):
    """Kernel ms a call of ``run`` from torch.profiler, after 3 warm-ups,
    and the ms a call of each of its kernels (names cut to 60
    characters)."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name[:60]
            by_name[name] = (by_name.get(name, 0.0)
                             + ev.self_device_time_total / 1e3 / calls)
    return sum(by_name.values()), by_name


def spread(samples):
    return dict(ms=statistics.median(samples), ms_min=min(samples),
                ms_max=max(samples))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_f32: needs an NVIDIA GPU (it times the "
                         "card's kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = nvidia_smi_name_power(0)
    for name, (b, h, s, d), causal in CASES:
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                       for _ in range(4))
        (o, lse), path = moved_path("flash_fwd", lambda: flash_fwd_cuda(
            q, k, v, causal, None, None, True))
        err = (o - flash_fwd_plain(q, k, v, causal)).abs().max().item()
        rec = dict(kernel="K6", case=name, shape=[b, h, s, d], causal=causal,
                   path=path, max_abs_err=err, card=smi)
        rec.update(spread(time_samples(
            lambda: flash_fwd_cuda(q, k, v, causal), 10, reps=5,
            graph=True)))
        rec["sdpa_ms"] = spread(time_samples(
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
            10, reps=5, graph=True))["ms"]
        print(json.dumps(rec), flush=True)

        _, path = moved_path("flash_bwd", lambda: flash_bwd_cuda(
            q, k, v, o, lse, do, causal))
        rec = dict(kernel="K7", case=name, shape=[b, h, s, d], causal=causal,
                   path=path, card=smi)
        rec.update(spread(time_samples(
            lambda: flash_bwd_cuda(q, k, v, o, lse, do, causal), 10, reps=5,
            graph=True)))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        rec["sdpa_autograd_profiled_ms"], rec["sdpa_kernels"] = profiled_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        rec["profiled_ms"], rec["kernels"] = profiled_ms(
            lambda: flash_bwd_cuda(q, k, v, o, lse, do, causal))
        print(json.dumps(rec), flush=True)
        del q, k, v, do, o, lse, leaves, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
