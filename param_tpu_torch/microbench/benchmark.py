"""Benchmark config model, executors and runner (port of
``param_tpu/microbench/benchmark.py``).

Counterparts of the reference's ``lib/config.py`` (BenchmarkConfig /
OperatorConfig), ``lib/pytorch/op_executor.py`` (OpExecutor: warmup +
measure, fwd/bwd passes), ``lib/pytorch/build_executor.py`` (materialize
build+input configs, run-id resume/stop, JSON-lines output) and
``lib/pytorch/benchmark.py`` (Benchmark.run).

Execution passes (reference ``ExecutionPass``): ``forward`` and ``backward``
(backward = ``torch.autograd.grad`` of the sum of the outputs, in f32,
with respect to the float tensor args, the forward included, as the JAX
package's ``jax.grad`` of the same loss).  ``chain`` mode times ``iters``
calls back to back between CUDA events (``perf_counter`` on the CPU) after
``warmup`` calls; ``discrete`` mode synchronises and times each call alone
(reference op_executor ``_benchmark_loop_discrete``) for a latency
distribution.  ``profile_dir``: one ``torch.profiler`` trace per (op run,
pass), outside the timed calls, its top 10 device operations in the record.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from param_tpu_torch.microbench.data import get_data_generator
from param_tpu_torch.microbench.iterator import get_config_iterator
from param_tpu_torch.microbench.operator import get_operator
from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.timer import sync, time_samples

log = logging.getLogger(__name__)


@dataclass
class OperatorConfig:
    """(reference: lib/config.py OperatorConfig / make_op_config:14-145)"""

    name: str
    build_iterator: str = "DefaultConfigIterator"
    input_iterator: str = "RangeConfigIterator"
    data_generator: str = "DefaultDataGenerator"
    configs: List[Dict[str, Any]] = field(default_factory=list)


class BenchmarkConfig:
    """(reference: lib/config.py BenchmarkConfig.load_json_file:127)"""

    def __init__(self, raw: Dict[str, Any]):
        self.ops: List[OperatorConfig] = []
        for name, spec in raw.items():
            if name.startswith("_"):  # comment/metadata keys
                continue
            self.ops.append(
                OperatorConfig(
                    name=name,
                    build_iterator=spec.get(
                        "build_iterator", "DefaultConfigIterator"
                    ),
                    input_iterator=spec.get(
                        "input_iterator", "RangeConfigIterator"
                    ),
                    data_generator=spec.get(
                        "input_data_generator", "DefaultDataGenerator"
                    ),
                    configs=spec.get("config", []),
                )
            )

    @classmethod
    def load_json_file(cls, path: str) -> "BenchmarkConfig":
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def loads(cls, text: str) -> "BenchmarkConfig":
        return cls(json.loads(text))


@dataclass
class RunOptions:
    """(reference: lib/config_util.py run options:16-148)"""

    warmup: int = 1
    iters: int = 10
    passes: str = "forward"  # forward | forward,backward
    mode: str = "chain"  # chain | discrete
    device: str = "cuda"
    resume_op_run_id: Optional[str] = None
    stop_op_run_id: Optional[str] = None
    out_stream: Any = None
    # per-op profiler orchestration (the reference's NCU/NSYS subprocess
    # batching, build_executor.py:125-151,247+): one torch.profiler trace
    # per (op run, pass), per-kernel device times extracted into the record
    profile_dir: Optional[str] = None


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _leaves(o)]
    return []


class OpExecutor:
    """Runs one materialized op config (reference: op_executor.py:31-515)."""

    def __init__(self, name: str, op, options: RunOptions):
        self.name = name
        self.op = op
        self.options = options
        self.device = torch.device(options.device)

    @staticmethod
    def _float_tensor_idx(args):
        return [i for i, a in enumerate(args)
                if isinstance(a, torch.Tensor) and a.is_floating_point()]

    def calls(self, args: list, kwargs: dict) -> Dict[str, Any]:
        """{"forward": call, "backward": call or None}: the calls that
        :meth:`run` times.  The backward pass is ``autograd.grad`` of the
        f32 sum of the outputs with respect to the float tensor args (None
        when there is none)."""
        op = self.op

        def fwd(*a):
            return op.forward(*a, **kwargs)

        ft = self._float_tensor_idx(args)

        def bwd():
            full = list(args)
            for i in ft:
                full[i] = args[i].detach().requires_grad_(True)
            loss = sum(l.float().sum() for l in _leaves(fwd(*full)))
            return torch.autograd.grad(loss, [full[i] for i in ft])

        return {"forward": lambda: fwd(*args),
                "backward": bwd if ft else None}

    def run(self, args: list, kwargs: dict,
            run_id: Optional[str] = None) -> Dict[str, Any]:
        self._run_id = run_id or self.name
        calls = self.calls(args, kwargs)
        results = {"forward": self._measure(calls["forward"], "forward")}
        if "backward" in self.options.passes:
            if calls["backward"] is not None:
                results["backward"] = self._measure(calls["backward"],
                                                    "backward")
            else:
                results["backward"] = {"error": "no differentiable tensor args"}
        return results

    def _profile(self, call, pass_name: str) -> Dict[str, Any]:
        """One dedicated ``torch.profiler`` trace for this (op run, pass)
        and per-kernel device-time extraction, run apart from the timed
        calls so that profiling never slows them (the reference splits NCU
        passes from timing passes the same way, build_executor.py:125-151).
        On the card the record keeps device work (kernels, copies, memsets)
        only; on the CPU, host operators."""
        from param_tpu_torch.trace.device_trace import (
            DEVICE_CATS, load_chrome_trace, op_durations,
        )
        from param_tpu_torch.utils.profiler import make_profiler

        d = os.path.join(self.options.profile_dir,
                         self._run_id.replace(":", "_"), pass_name)
        os.makedirs(d, exist_ok=True)
        try:
            prof = make_profiler(self.device)
            prof.start()
            try:
                call()
                sync(self.device)
            finally:
                prof.stop()
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
            events, threads = load_chrome_trace(d)
            if self.device.type == "cuda":
                events = [e for e in events if e.get("cat") in DEVICE_CATS]
            agg = op_durations(events, threads)
            top = sorted(agg.items(), key=lambda kv: -kv[1]["total_us"])[:10]
            return {"dir": d,
                    "device_ops": [{"name": k, **v} for k, v in top]}
        except Exception as e:  # noqa: BLE001
            log.exception("profiling %s failed", self._run_id)
            return {"dir": d, "error": str(e)[:200]}

    def _measure(self, call, pass_name: str) -> Dict[str, Any]:
        opts = self.options
        dev = self.device
        try:
            if opts.mode == "discrete":
                for _ in range(max(1, opts.warmup)):
                    call()
                lats = []
                for _ in range(opts.iters):
                    lats.append(time_samples(call, 1, dev, warmup=0)[0] * 1e3)
                lats.sort()
                rec = {
                    "lat_us_p50": lats[len(lats) // 2],
                    "lat_us_min": lats[0],
                    "lat_us_max": lats[-1],
                    "iters": opts.iters,
                }
            else:
                ms = time_samples(call, opts.iters, dev,
                                  warmup=max(1, opts.warmup))[0]
                rec = {"lat_us": ms * 1e3, "iters": opts.iters}
            if opts.profile_dir:
                rec["profile"] = self._profile(call, pass_name)
            return rec
        except Exception as e:  # noqa: BLE001
            log.exception("op %s failed", self.name)
            return {"error": str(e)[:300]}


class BuildExecutor:
    """Materializes build/input configs and emits JSON-lines results
    (reference: build_executor.py; resume/stop state machine :72-102,
    output_stats :508)."""

    def __init__(self, options: RunOptions):
        self.options = options
        self.device = torch.device(options.device)
        self._started = options.resume_op_run_id is None
        self._stopped = False

    def run_op_config(self, op_cfg) -> List[Dict[str, Any]]:
        results = []
        op = get_operator(op_cfg.name)
        op.device = self.device
        gen = get_data_generator(op_cfg.data_generator)(self.device)
        build_iter_cls = get_config_iterator(op_cfg.build_iterator)
        input_iter_cls = get_config_iterator(op_cfg.input_iterator)
        # build configs (may be absent -> single no-op build)
        build_cfgs = list(build_iter_cls(op_cfg.configs, key="build")) or [
            {"args": [], "kwargs": {}}
        ]
        for b_id, build_cfg in enumerate(build_cfgs):
            b_args, b_kwargs = gen.get_data(build_cfg)
            op.build(*b_args, **b_kwargs)
            for i_id, input_cfg in enumerate(
                input_iter_cls(op_cfg.configs, key="input")
            ):
                run_id = f"{op_cfg.name}:{b_id}:{i_id}"
                if not self._started:
                    if run_id == self.options.resume_op_run_id:
                        self._started = True
                    else:
                        continue
                if self._stopped:
                    return results
                args, kwargs = gen.get_data(input_cfg)
                ex = OpExecutor(op_cfg.name, op, self.options)
                measured = ex.run(args, kwargs, run_id=run_id)
                record = {
                    "name": op_cfg.name,
                    "run_id": run_id,
                    "config": {
                        "build": build_cfg,
                        "input": _spec_summary(input_cfg),
                    },
                    **measured,
                }
                results.append(record)
                if self.options.out_stream is not None:
                    self.options.out_stream.write(json.dumps(record) + "\n")
                    self.options.out_stream.flush()
                if run_id == self.options.stop_op_run_id:
                    self._stopped = True
                    return results
            op.cleanup()
        return results


def _spec_summary(cfg: Dict[str, Any]) -> Dict[str, Any]:
    def brief(a):
        if isinstance(a, dict) and a.get("type") == "tensor":
            return {"type": "tensor", "dtype": a.get("dtype"),
                    "shape": a.get("shape")}
        return a

    return {"args": [brief(a) for a in cfg.get("args", [])]}


class Benchmark:
    """(reference: lib/pytorch/benchmark.py Benchmark.run:58); runs on
    ``options.device`` (default ``"cuda"``: raises without a GPU unless the
    caller asks for the CPU)."""

    def __init__(self, config: BenchmarkConfig, options: RunOptions):
        self.config = config
        self.options = options
        resolve_device(options.device)

    def run(self) -> List[Dict[str, Any]]:
        from param_tpu_torch.microbench.operator import load_workloads

        load_workloads()
        executor = BuildExecutor(self.options)
        all_results = []
        for op_cfg in self.config.ops:
            try:
                all_results.extend(executor.run_op_config(op_cfg))
            except Exception:  # noqa: BLE001
                log.exception("op config %s failed", op_cfg.name)
        return all_results
