"""DLRM communication-pattern benchmark with per-region timing (port of
``param_tpu/models/dlrm_bench.py``).

Times each region of the sharded DLRM step (sparse index exchange,
embedding lookup, pooled-embedding all-to-all, dense forward, backward
pieces, the whole train step) and reports min / p50 / p75 / p95 per region
with the region's payload bytes, QPS, and the ``--print-comms`` JSON trace
(basic schema).  The reference times 21 eager regions with CUDA events
(PARAM's ``initTimers``, ``train/comms/pt/dlrm.py:961-1009``); so does this
port: each region is an eager callable on this rank's tensors, running the
op or collective that the JAX package's chain body for that region runs.

A region's callable takes the call's counter i, and shifts the ids by it
(``(idx + i) % E``), as the JAX chains do; float inputs are not perturbed
(an eager call is never hoisted).  One timing is a window of ``chain``
calls between two CUDA events (``perf_counter`` on the CPU), after one
untimed window; a window shorter than 1 ms doubles, up to ``max_chain``
calls, with every rank taking the same length (the shortest window of the
group decides), so the collectives stay matched.  Each region gets ``reps``
windows; their per-call times are pooled over the ranks before the
percentiles (the reference's all-gather of each rank's samples).

``bwd_opt(derived)`` is step_total - fwd_total.  The per-phase backward
rows marked ``(iso)`` time the op an eager backward region would contain,
alone.  The reference's scalar-fetch chains (``measure_chain``) answer a
TPU timing problem and are not ported.
"""

from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from param_tpu_torch.models.dlrm import (
    DlrmModel, _bce, _forward_local, _lookup_local_tables, all_to_all_rows,
    all_to_all_tables, dot_interaction,
)
from param_tpu_torch.models.dlrm_data import RandomDataset
from param_tpu_torch.ops.mlp import mlp_forward, tree_leaves
from param_tpu_torch.utils.dtypes import dtype_size
from param_tpu_torch.utils.sizes import percentile
from param_tpu_torch.utils.timer import time_samples

MIN_WINDOW_MS = 1.0

# The reference's 21 timer regions (initTimers, dlrm.py:961-1009), as the
# JAX package names them; (iso) rows time the op of a backward region alone.
REGIONS = [
    "calc_length",      # offsets -> per-table lengths (data prep)
    "mem_push_idx",     # H2D push of the index batch
    "send_splits",      # per-destination send counts from lengths
    "offset_xchg",      # lengths all-to-all (ragged pipeline stage 1)
    "recv_splits",      # recv offsets (cumsum of exchanged lengths)
    "idx_xchg",         # index redistribution all-to-all
    "split_per_table",  # regroup received idx per local table
    "emb_lookup",       # apply_emb
    "fwd_a2a",          # pooled-embedding forward all-to-all
    "post_a2a_fwd",     # interaction + top MLP + loss after the a2a
    "mem_push_gradients",  # H2D push of the label batch
    "bot_mlp_fwd",      # bottom MLP forward
    "interaction",      # dot-feature interaction
    "top_mlp_fwd",      # top MLP forward
    "dense_fwd",        # bot MLP + interaction + top MLP combined
    "fwd_total",        # full forward (loss)
    "bwd_a2a(iso)",     # transposed pooled a2a (comm 5)
    "bwd_top_ar(iso)",  # top-MLP grad all-reduce (comm 4)
    "bwd_bot_ar(iso)",  # bot-MLP grad all-reduce (comm 6)
    "top_mlp_bwd(iso)",  # top-MLP fwd+grad
    "bot_mlp_bwd(iso)",  # bottom-MLP fwd+grad
    "step_total",       # forward + backward + optimizer
]

# The reference's 21 report rows (reportBenchTime all_timers,
# dlrm.py:1015-1036) -> (region key, derived) in reference order.
# derived=None rows are measured; a tuple lists the measured regions the
# cumulative row sums (the reference times iter_start..<marker> spans).
REF_ROWS = [
    ("intermed_calc_length", "calc_length", None),
    ("mem_push_idx", "mem_push_idx", None),
    ("intermed_bef_offset_xchg", "send_splits", None),
    ("offset_xchg", "offset_xchg", None),
    ("intermed_btw_offset_idx_xchg", "recv_splits", None),
    ("idx_xchg", "idx_xchg", None),
    ("intermed_post_idx_xchg_sparse_dist", "split_per_table", None),
    ("intermed_emb_lookup_to_a2a_start", "emb_lookup", None),
    ("fwd_a2a", "fwd_a2a", None),
    ("intermed_fwd_a2a_grad_push", "post_a2a_fwd", None),
    ("mem_push_gradients", "mem_push_gradients", None),
    ("bwd_top_ar", "bwd_top_ar(iso)", None),
    ("intermed_top_ar_end_to_bwd_a2a_start", "top_mlp_bwd(iso)", None),
    ("bwd_a2a", "bwd_a2a(iso)", None),
    ("intermed_bwd_a2a_bot_ar", "bot_mlp_bwd(iso)", None),
    ("bwd_bot_ar", "bwd_bot_ar(iso)", None),
    ("iter_time", "step_total", None),
    ("iter_data_prep", None,
     ("calc_length", "mem_push_idx", "send_splits", "offset_xchg",
      "recv_splits", "idx_xchg", "split_per_table")),
    ("iter_fwd_a2a", None,
     ("calc_length", "mem_push_idx", "send_splits", "offset_xchg",
      "recv_splits", "idx_xchg", "split_per_table", "emb_lookup",
      "fwd_a2a")),
    ("iter_bwd_top_ar", None,
     ("calc_length", "mem_push_idx", "send_splits", "offset_xchg",
      "recv_splits", "idx_xchg", "split_per_table", "emb_lookup",
      "fwd_a2a", "post_a2a_fwd", "mem_push_gradients", "bwd_top_ar(iso)")),
    ("iter_bwd_a2a", None,
     ("calc_length", "mem_push_idx", "send_splits", "offset_xchg",
      "recv_splits", "idx_xchg", "split_per_table", "emb_lookup",
      "fwd_a2a", "post_a2a_fwd", "mem_push_gradients", "bwd_top_ar(iso)",
      "top_mlp_bwd(iso)", "bwd_a2a(iso)")),
]


class DlrmCommBench:
    def __init__(self, model: DlrmModel, optimizer, lr: float = 0.01):
        """``model`` is sharded over a group (a world of one included).
        ``optimizer`` is an optimizer of ``ops.mlp`` for the dense step, or
        ``"sparse_sgd"`` / ``"sparse_adagrad"`` for the sparse-row step."""
        if model.group is None:
            raise ValueError("the DLRM bench runs over a process group")
        self.model = model
        self.optimizer = optimizer
        self.lr = lr
        cfg = model.cfg
        self.n = model.n
        self.local_batch = cfg.batch // self.n
        self.local_tables = cfg.num_tables // self.n

    # ------------------------------------------------------------- regions
    def make_regions(self, params, batch) -> Dict[str, Callable[[int], object]]:
        """One eager callable per region, on this rank's tensors; each takes
        the call's counter."""
        model, cfg = self.model, self.model.cfg
        pg, n = model.group.pg, self.n
        dense, idx, labels = batch
        tables = params["tables"]
        E, b, dev = cfg.rows_per_table, self.local_batch, model.device
        lengths = torch.full((b, cfg.num_tables), cfg.nnz, dtype=torch.int32,
                             device=dev)
        offsets = torch.cat([torch.zeros_like(lengths[:, :1]),
                             torch.cumsum(lengths, 1, dtype=torch.int32)], 1)
        with torch.no_grad():
            idx_local = model._exchange_ids(idx)
            pooled_local = _lookup_local_tables(tables, idx_local)
            bot_out = mlp_forward(params["bot"], dense)
        ones_pooled = torch.ones((b, cfg.num_tables, cfg.emb_dim),
                                 dtype=cfg.dtype, device=dev)
        zeros_pooled = torch.zeros_like(ones_pooled)
        zeros_feat = torch.zeros((b, cfg.interaction_dim), dtype=cfg.dtype,
                                 device=dev)
        ones_feat = torch.ones_like(zeros_feat)
        sharded_loss = model.make_sharded_loss()
        top_leaves = [t.detach() for t in tree_leaves(params["top"])]
        bot_leaves = [t.detach() for t in tree_leaves(params["bot"])]

        def mlp_bwd(which, x0):
            def fn(i):
                x = x0.detach().requires_grad_(True)
                out = mlp_forward(params[which], x).sum()
                return torch.autograd.grad(out, tree_leaves(params[which])
                                           + [x])
            return fn

        fwd_only = {
            "calc_length": lambda i: (offsets + i)[:, 1:]
            - (offsets + i)[:, :-1],
            "send_splits": lambda i: (lengths + i % 2).reshape(
                b, n, -1).sum(dim=(0, 2)),
            # a lengths-shaped payload: one int32 per (sample, table)
            "offset_xchg": lambda i: all_to_all_tables(
                idx[:, :, 0] + i % 2, pg, n),
            "recv_splits": lambda i: torch.cumsum(
                (lengths + i % 2).reshape(-1), 0),
            "idx_xchg": lambda i: all_to_all_tables((idx + i) % E, pg, n),
            # splitPerTable (dlrm.py:430-457): (B, T/n, nnz) regrouped
            # per-table contiguous
            "split_per_table": lambda i: ((idx_local + i) % E).transpose(
                0, 1).contiguous(),
            "emb_lookup": lambda i: _lookup_local_tables(
                tables, (idx_local + i) % E),
            "fwd_a2a": lambda i: all_to_all_rows(pooled_local, pg, n),
            "post_a2a_fwd": lambda i: _bce(mlp_forward(
                params["top"], dot_interaction(bot_out, ones_pooled))[:, 0],
                labels),
            "bot_mlp_fwd": lambda i: mlp_forward(params["bot"], dense),
            "interaction": lambda i: dot_interaction(bot_out, ones_pooled),
            "top_mlp_fwd": lambda i: mlp_forward(params["top"], zeros_feat),
            "dense_fwd": lambda i: _forward_local(params, cfg, dense,
                                                  zeros_pooled),
            "fwd_total": lambda i: sharded_loss(params, dense, (idx + i) % E,
                                                labels),
            "bwd_a2a(iso)": lambda i: all_to_all_tables(ones_pooled, pg, n),
            "bwd_top_ar(iso)": lambda i: model.mean_over_ranks(top_leaves),
            "bwd_bot_ar(iso)": lambda i: model.mean_over_ranks(bot_leaves),
        }
        out = {k: torch.no_grad()(fn) for k, fn in fwd_only.items()}
        out["top_mlp_bwd(iso)"] = mlp_bwd("top", ones_feat)
        out["bot_mlp_bwd(iso)"] = mlp_bwd("bot", dense)
        out["step_total"] = self._step(params, batch)
        out["mem_push_idx"] = self._host_push(idx)
        out["mem_push_gradients"] = self._host_push(labels)
        return out

    def _host_push(self, local: torch.Tensor):
        """H2D push region (reference mem_push_idx / mem_push_gradients,
        dlrm.py:1214-1222): this rank's batch rows copied from one of 4
        DISTINCT pageable host buffers into a new device tensor."""
        host = local.cpu().numpy()
        variants = [torch.from_numpy(host + np.asarray(i, dtype=host.dtype))
                    for i in range(4)]
        dev = self.model.device

        def push(i):
            src = variants[i % len(variants)]
            return torch.empty(src.shape, dtype=src.dtype,
                               device=dev).copy_(src)

        return push

    def _step(self, params, batch):
        """The real train step (dense, or the sparse-row one), carrying
        ``params`` and the optimizer state from call to call."""
        model = self.model
        dense, idx, labels = batch
        E = model.cfg.rows_per_table
        if self.optimizer == "sparse_sgd":
            step = model.make_sparse_sgd_step(self.lr)
            return lambda i: step(params, dense, (idx + i) % E, labels)
        if self.optimizer == "sparse_adagrad":
            step = model.make_sparse_adagrad_step(self.lr)
            acc = model.init_adagrad_state(params)
            return lambda i: step(params, acc, dense, (idx + i) % E, labels)
        step = model.make_train_step(self.optimizer)
        st = self.optimizer.init(params)
        return lambda i: step(params, st, dense, (idx + i) % E, labels)

    # ------------------------------------------------------------- timing
    def _group_min(self, x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64, device=self.model.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.model.group.pg)
        return float(t.item())

    def time_region(self, fn: Callable[[int], object], reps: int, chain: int,
                    max_chain: int) -> List[float]:
        """Per-call microseconds of ``reps`` windows (see the module
        notes)."""
        dev = self.model.device
        counter = itertools.count()
        call = lambda: fn(next(counter))  # noqa: E731
        n = max(1, min(chain, max_chain))
        ms = time_samples(call, n, dev)[0]  # after one untimed window
        while self._group_min(ms * n) < MIN_WINDOW_MS and n < max_chain:
            n = min(2 * n, max_chain)
            ms = time_samples(call, n, dev, warmup=0)[0]
        return [t * 1e3 for t in time_samples(call, n, dev, warmup=0,
                                              reps=reps)]

    def run(self, reps: int = 3, chain: int = 8,
            regions: Optional[List[str]] = None,
            max_chain: int = 1024) -> Dict[str, Dict]:
        """Time each region (``regions``: a subset of the names, default
        all) on a batch of ``RandomDataset``, with the parameters of
        ``model.init_params(0)``."""
        cfg = self.model.cfg
        ds = RandomDataset(
            batch=cfg.batch, dense_dim=cfg.dense_dim, num_tables=cfg.num_tables,
            nnz=cfg.nnz, num_rows=cfg.rows_per_table, num_batches=1,
        )
        params = self.model.init_params(0)
        batch = self.model.place_batch(next(iter(ds)))
        fns = self.make_regions(params, batch)
        if regions is not None:
            unknown = set(regions) - set(fns)
            if unknown:
                raise ValueError(f"unknown regions {sorted(unknown)}; "
                                 f"known: {sorted(fns)}")
            fns = {k: v for k, v in fns.items() if k in regions}
        mem = self.region_memory_bytes()
        results: Dict[str, Dict] = {}
        for name, fn in fns.items():
            us = self._gather_cross_rank(
                self.time_region(fn, reps, chain, max_chain))
            results[name] = {
                "min_us": min(us),
                "p50_us": percentile(us, 50),
                "p75_us": percentile(us, 75),
                "p95_us": percentile(us, 95),
                "mem_bytes": mem.get(name, 0),
            }
        # the reference's cumulative iter_* rows (sums of their measured
        # regions; iter_time is the real step, measured as step_total)
        for ref_name, key, parts in REF_ROWS:
            if parts is None or not all(p in results for p in parts):
                continue
            results[ref_name] = {
                k: sum(results[p][k] for p in parts)
                for k in ("min_us", "p50_us", "p75_us", "p95_us")
            }
            results[ref_name]["mem_bytes"] = 0
        if "step_total" in results and "fwd_total" in results:
            results["bwd_opt(derived)"] = {
                k: max(0.0, results["step_total"][k] - results["fwd_total"][k])
                for k in results["step_total"]
            }
        if "step_total" in results:
            step_us = results["step_total"]["p50_us"]
            results["_summary"] = {
                "qps": cfg.batch / (step_us / 1e6) if step_us else 0.0,
                "batch": cfg.batch,
                "world": self.n,
            }
        return results

    def _gather_cross_rank(self, us: List[float]) -> List[float]:
        """Every rank's samples, pooled (the reference's all-gather of the
        per-rank latency tensor, dlrm.py:1044-1063): percentiles are then
        over ranks x reps."""
        t = torch.tensor(us, dtype=torch.float64, device=self.model.device)
        out = t.new_empty(self.n * t.numel())
        dist.all_gather_into_tensor(out, t, group=self.model.group.pg)
        return out.tolist()

    def region_memory_bytes(self) -> Dict[str, int]:
        """Per-region payload bytes (reference memory column semantics:
        comm regions record their transfer size, mem_push regions the
        pushed bytes, intermed regions 0 — dlrm.py:788,834,1292,1318 and
        intermed_region_memory :912-934)."""
        cfg = self.model.cfg
        es = dtype_size(cfg.dtype)
        idx_bytes = self.local_batch * cfg.num_tables * cfg.nnz * 4
        pooled_bytes = cfg.batch * self.local_tables * cfg.emb_dim * es
        dims_b = cfg.bot_mlp_dims()
        dims_t = cfg.top_mlp_dims()
        bot_bytes = sum(a * b + b for a, b in zip(dims_b[:-1], dims_b[1:])) * es
        top_bytes = sum(a * b + b for a, b in zip(dims_t[:-1], dims_t[1:])) * es
        return {
            "offset_xchg": self.local_batch * cfg.num_tables * 4,
            "idx_xchg": idx_bytes,
            "mem_push_idx": idx_bytes,
            "mem_push_gradients": self.local_batch * es,
            "fwd_a2a": pooled_bytes,
            "bwd_a2a(iso)": pooled_bytes,
            "bwd_top_ar(iso)": top_bytes,
            "bwd_bot_ar(iso)": bot_bytes,
        }

    def report(self, results: Dict[str, Dict]) -> None:
        """Reference-format report: the 21 named rows in reference order
        (memory(B), min/p50/p75/p95, running sum of p50 over the 16
        sequential rows — reportBenchTime, dlrm.py:1084-1135), then the
        rows outside the reference's table."""
        cfg = self.model.cfg
        print(f"\nDLRM-RES world={self.n} batch={cfg.batch} "
              f"tables={cfg.num_tables}x{cfg.rows_per_table}"
              f"x{cfg.emb_dim} nnz={cfg.nnz}")
        hdr = (f"{'region':>38}{'memory(B)':>12}{'min(us)':>12}{'p50':>12}"
               f"{'p75':>12}{'p95':>12}{'sum(p50)':>12}")
        print(hdr)
        shown = set()
        sum_p50 = 0.0
        for ref_name, key, parts in REF_ROWS:
            r = results.get(ref_name if parts else key)
            if r is None:
                continue
            shown.add(ref_name if parts else key)
            if parts is None and ref_name != "iter_time":
                sum_p50 += r["p50_us"]
            print(f"{ref_name:>38}{r.get('mem_bytes', 0):>12}"
                  f"{r['min_us']:>12.1f}{r['p50_us']:>12.1f}"
                  f"{r['p75_us']:>12.1f}{r['p95_us']:>12.1f}"
                  f"{sum_p50:>12.1f}")
        extras = [k for k in results
                  if not k.startswith("_") and k not in shown]
        if extras:
            print(f"{'--- further rows ---':>38}")
            for name in extras:
                r = results[name]
                print(f"{name:>38}{r.get('mem_bytes', 0):>12}"
                      f"{r.get('min_us', r['p50_us']):>12.1f}"
                      f"{r['p50_us']:>12.1f}{r['p75_us']:>12.1f}"
                      f"{r['p95_us']:>12.1f}{'':>12}")
        s = results.get("_summary")
        if s:
            print(f"QPS: {s['qps']:.1f}")

    # ----------------------------------------------------------- print-comms
    def comms_trace(self) -> List[dict]:
        """The step's communication pattern as a basic-schema JSON trace
        (reference: --print-comms, dlrm.py:1393-1402; schema:
        commsTraceParser._parseBasicTrace)."""
        cfg = self.model.cfg
        n = self.n
        es = dtype_size(cfg.dtype)
        idx_bytes = self.local_batch * cfg.num_tables * cfg.nnz * 4
        pooled_bytes = cfg.batch * self.local_tables * cfg.emb_dim * es
        bot_params = sum(
            a * b + b for a, b in zip(cfg.bot_mlp_dims()[:-1], cfg.bot_mlp_dims()[1:])
        )
        top_params = sum(
            a * b + b for a, b in zip(cfg.top_mlp_dims()[:-1], cfg.top_mlp_dims()[1:])
        )

        def comm(name, in_bytes, out_bytes, dtype="float32", markers=None):
            return {
                "comms": name,
                "in_msg_size": in_bytes // es,
                "out_msg_size": out_bytes // es,
                "dtype": dtype,
                "world_size": n,
                "markers": markers or [name],
            }

        return [
            comm("all_to_all", idx_bytes, idx_bytes, "int32", ["idx_xchg"]),
            comm("all_to_all", pooled_bytes, pooled_bytes, "float32", ["fwd_a2a"]),
            comm("all_reduce", top_params * es, top_params * es, "float32",
                 ["bwd_top_ar"]),
            comm("all_to_all", pooled_bytes, pooled_bytes, "float32", ["bwd_a2a"]),
            comm("all_reduce", bot_params * es, bot_params * es, "float32",
                 ["bwd_bot_ar"]),
        ]

    def dump_comms(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.comms_trace(), f, indent=2)
