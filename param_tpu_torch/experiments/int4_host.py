"""Host cost of an eager K5 call, and of the int4 decode step, on K5's
schedule beside the parent design (the mma_sync kernel and its reduce
kernel), in one process.

For the llama2 decode projections at batch 1 (QKV (1, 4096) @ (4096,
12288), O (4096, 4096), FFN up (4096, 11008) and down (11008, 4096); g =
128) this prints one JSON line per projection: for each design the
host-clock microseconds a call (``perf_counter`` around 50 back-to-back
eager calls and a synchronise; the calls are host-bound) and the card's ms
a call (CUDA-graph replays, median of 5 windows).  Then the full-width
llama2 int4 ``decode_step`` at batch 1 and 32 (cache 2048): host-clock ms
a step around 20 steps and a synchronise.  The two designs take turns
window by window (9 windows each, medians printed), so host noise falls on
both alike.

    python -m param_tpu_torch.experiments.int4_host
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time

import torch

import param_tpu_torch.kernels.int4_gemm as k5
from param_tpu_torch.models import transformer as tfm
from param_tpu_torch.utils.chip import nvidia_smi_name_power
from param_tpu_torch.utils.timer import time_samples

PROJECTIONS = [("qkv", 4096, 12288), ("o", 4096, 4096),
               ("ffn_up", 4096, 11008), ("ffn_down", 11008, 4096)]
CALLS, STEPS, WINDOWS = 50, 20, 9


# K5's schedule, and the parent's design (the mma_sync kernel and its
# reduce kernel)
DESIGNS = {"schedule": contextlib.nullcontext,
           "parent": lambda: k5.forced_path("mma_sync")}


def alternate(fn, reps: int, windows: int):
    """Host-clock ms a call of ``fn`` on K5's schedule and on the parent
    design: medians over ``windows`` windows of ``reps`` calls ending in a
    synchronise, the designs taking turns, after a warm-up of each."""
    out = {d: [] for d in DESIGNS}
    for ctx in DESIGNS.values():
        with ctx():
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        for d, ctx in DESIGNS.items():
            with ctx():
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                out[d].append((time.perf_counter() - t0) * 1e3 / reps)
    return {d: statistics.median(v) for d, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("int4_host: needs an NVIDIA GPU (it times the "
                         "card's kernels)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = nvidia_smi_name_power(0)
    for name, k, n in PROJECTIONS:
        x = torch.randn((1, k), generator=gen, device=dev).bfloat16()
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen,
                               device=dev, dtype=torch.int32).to(torch.int8)
        scale = torch.rand((k // 128, n), generator=gen, device=dev) * 0.02
        fn = lambda: k5.int4_gemm_cuda(x, packed, scale)  # noqa: E731
        host = alternate(fn, CALLS, WINDOWS)
        card = {}
        for d, ctx in DESIGNS.items():
            with ctx():
                card[d] = statistics.median(
                    time_samples(fn, 50, reps=5, graph=True))
        print(json.dumps({
            "projection": name, "shape": [1, k, n],
            "host_us": {d: v * 1e3 for d, v in host.items()},
            "card_ms": card, "card": smi}), flush=True)
    e, h, ff = 4096, 32, 11008
    for b in (1, 32):
        cfg = tfm.TransformerConfig(batch=b, seq=1, emb=e, heads=h, ffn=ff,
                                    attention="xla")
        params = tfm.cast_int4_params(tfm.quantize_block_weights_int4(
            tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)))
        shape = (b, h, 2048, e // h)
        cache = {"k": torch.randn(shape, generator=gen, device=dev).bfloat16(),
                 "v": torch.randn(shape, generator=gen, device=dev).bfloat16()}
        x1 = (torch.randn((b, 1, e), generator=gen, device=dev)
              * 0.1).bfloat16()
        with torch.no_grad():
            host = alternate(
                lambda: tfm.decode_step(params, cache, x1, 2046, cfg),
                STEPS, WINDOWS)
        print(json.dumps({"decode_step_int4_batch": b, "host_ms": host,
                          "card": smi}), flush=True)
        del params, cache, x1
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
