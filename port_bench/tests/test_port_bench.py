"""CPU tests of the port's benchmark harness (``port_bench``).

They run the port's plain paths at a tiny size: the discovery of cells,
configurations and metrics by name; the reference against the port's train
steps (both optimizers, one device and a sharded world of one); the control
and the planted faults, which must come out not correct; the FLOP, byte and
trace arithmetic against hand-worked numbers; the no-JAX import walk; and a
run's refusal without a card.  The ``cuda`` tests need a card and skip
without one.

    python -m pytest port_bench/tests -q
    python -m pytest port_bench/tests -q -m cuda     # on the card
"""

from __future__ import annotations

import ast
import functools
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from port_bench import calibrate, check, counts, reference, run, spec, trace, worker

ROOT = spec.ROOT
SEED = 2**33 + 5


def tiny_cell(optimizer="sparse_adagrad", ids="uniform", chips=1,
              limits_of="rm8x1m.adagrad.uniform", batch=64):
    """A cut-down dlrm-random-8x1m with a real cell's limits."""
    cfg = dict(spec.load_json(os.path.join(spec.HERE, "configs",
                                           "dlrm-random-8x1m.json")))
    cfg.update(num_tables=4, rows_per_table=512, emb_dim=16, nnz=4,
               dense_dim=16, bot_mlp=[32, 16], top_mlp=[32, 1],
               optimizer=optimizer)
    traffic = {"batch": batch, "ids": ids, "zipf_alpha": 1.15, "ring": 4}
    return spec.Cell("tiny", cfg, traffic, chips, spec.cell(limits_of).limits)


def run_line(cell, rank_job=None):
    """A whole run on the CPU, past the look for a card: its result line."""
    out = run.run_cell(cell, SEED, 0.05, False, device_type="cpu",
                       rank_job=rank_job)
    return run.result_line(cell, out, False, {"platform": "cpu",
                                              "kind": "cpu", "count": 1})


# ---------------------------------------------------------------- discovery
def test_every_part_is_found_by_name():
    bench = spec.benchmark()
    assert bench["paths"] == ["port_bench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert spec.load_json(os.path.join(ROOT, c["file"]))["name"] == \
            c["name"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"] in configs
        assert cell.chips == w["chips"]
        assert set(cell.limits) == set(check.NAMES)
        assert spec.model(cell.config["model"]).NAME == cell.config["model"]
        for kind in ("end_to_end", "per_layer"):
            entries = {m["name"]: m for m in bench[kind]
                       if w["name"] in m.get("workloads", [w["name"]])}
            mods = spec.metrics(kind, w["name"])
            assert sorted(m.NAME for m in mods) == sorted(entries)
            for m in mods:
                assert m.UNIT == entries[m.NAME]["unit"]
                if kind == "per_layer":
                    assert m.LAYER == entries[m.NAME]["layer"]
                    assert m.MOVES == entries[m.NAME]["moves"]


@pytest.mark.parametrize("change", [{"tf32": True}, {"model": "gpt"},
                                    {"dtype": "bfloat16"},
                                    {"arch_interaction": "cat"}])
def test_a_configuration_the_harness_would_not_run_as_stated_is_refused(
        change):
    cell = tiny_cell()
    cell.config.update(change)
    with pytest.raises(ValueError):
        spec.model("dlrm").dlrm_config(cell.config, cell.traffic)


def test_names_outside_the_rules_are_refused():
    for bad in ("../BENCHMARK", "a b", "", "x" * 65, "/etc/passwd"):
        with pytest.raises(ValueError):
            spec.check_name(bad)


# ------------------------------------------------- reference against program
@pytest.mark.parametrize("optimizer,ids", [
    ("sparse_adagrad", "uniform"), ("sparse_sgd", "zipf"),
    ("sparse_adagrad", "zipf"), ("sparse_sgd", "uniform")])
def test_port_steps_match_the_reference(optimizer, ids):
    line = run_line(tiny_cell(optimizer, ids))
    assert line["correct"], line["checks"]
    for k, c in line["checks"].items():
        assert c["value"] < 1e-5, k


def test_sharded_world_of_one_matches_the_reference():
    from param_tpu_torch.backend import DistBackend

    cell = tiny_cell()
    backend = DistBackend("cpu")
    backend.initialize()
    try:
        out = worker.run_rank(cell, SEED, 0.05, False, 0, 1,
                              backend.get_default_group(),
                              torch.device("cpu"))
    finally:
        backend.shutdown()
    ref = reference.readings(cell.config, cell.traffic, SEED, 1, "cpu")
    values = check.gaps(out["readings"], ref)
    assert check.verdict(values, cell.limits), values


# ------------------------------------------------------ control and faults
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_in_tf32_is_not_correct(seed):
    cell = tiny_cell(batch=256)
    ref = reference.readings(cell.config, cell.traffic, seed, 1, "cpu")
    control = reference.readings(cell.config, cell.traffic, seed, 1, "cpu",
                                 tf32=True)
    assert not check.verdict(check.gaps(control, ref), cell.limits)


def test_calibration_judges_the_program_correct_and_the_control_not():
    cell = tiny_cell(batch=256)
    lines = calibrate.calibrate(cell, [11, 12], device_type="cpu")
    for line in lines:
        assert line["program"]["correct"], line
        assert not line["control"]["correct"], line
        assert not line["half_batch"]["correct"], line


def _step_unchanged(factory):
    def make(self, *a, **kw):
        factory(self, *a, **kw)

        def step(params, *rest):
            with torch.no_grad():
                loss = self.loss_fn(params, *rest[-3:])
            return (params, *rest[:-3], loss)
        return step
    return make


def _step_on_half_batch(factory):
    def make(self, *a, **kw):
        inner = factory(self, *a, **kw)

        def step(params, *rest):
            *state, dense, idx, labels = rest
            h = dense.shape[0] // 2
            return inner(params, *state, dense[:h], idx[:h], labels[:h])
        return step
    return make


def _broken(fault, *args, **kw):
    """:func:`worker.run_rank` with the port's train steps broken by
    ``fault`` in this process (a rank's process, on several ranks)."""
    from param_tpu_torch.models.dlrm import DlrmModel

    for opt in ("sgd", "adagrad"):
        name = f"make_sparse_{opt}_step"
        setattr(DlrmModel, name, fault(getattr(DlrmModel, name)))
    return worker.run_rank(*args, **kw)


def _without_dense_mean(*args, **kw):
    """:func:`worker.run_rank` with the dense gradients' mean over the ranks
    (their all-reduce) left out."""
    from param_tpu_torch.models.dlrm import DlrmModel

    DlrmModel._mean_dense_grads = lambda self, mlps, g: list(g)
    return worker.run_rank(*args, **kw)


@pytest.mark.parametrize("fault", [_step_unchanged, _step_on_half_batch])
@pytest.mark.parametrize("optimizer", ["sparse_adagrad", "sparse_sgd"])
@pytest.mark.parametrize("chips", [1, 2])
def test_a_broken_step_is_not_correct(fault, optimizer, chips):
    cell = tiny_cell(optimizer, chips=chips)
    assert not run_line(cell, functools.partial(_broken, fault))["correct"]


def test_two_ranks_match_and_a_missing_exchange_is_not_correct():
    cell = tiny_cell(chips=2, limits_of="rm8x1m.adagrad.uniform.x4")
    assert run_line(cell)["correct"]
    assert not run_line(cell, _without_dense_mean)["correct"]


# ------------------------------------------------------------- arithmetic
def test_flop_and_byte_counts_by_hand():
    # layer 3->4 without an input gradient: 2 passes of 2*5*3*4 = 240;
    # layer 4->2: 3 passes of 2*5*4*2 = 240
    assert counts.mlp_flops([3, 4, 2], 5, input_grad=False) == 480
    assert counts.mlp_flops([3, 4, 2], 5, input_grad=True) == 600
    cfg = {"num_tables": 2, "emb_dim": 4, "dense_dim": 3, "bot_mlp": [4],
           "top_mlp": [2, 1]}
    # interaction: m = 3, 3 products of 2*5*3*3*4 = 360; the top MLP's
    # input is 4 + 3 = 7 wide: 3 passes of 2*5*(7*2 + 2*1) = 480
    assert counts.interaction_flops(cfg, 5) == 1080
    assert counts.step_flops(cfg, 5) == 2 * 2 * 5 * 3 * 4 + 480 + 1080
    # 7 unique rows of 16 bytes, 10 bags of 3 ids, 10 pooled rows
    assert counts.lookup_bytes(7, 10, 3, 4) == 112 + 120 + 160
    # table, accumulator read and written, gradient row and id read
    assert counts.update_bytes(7, 4, adagrad=True) == 7 * (16 * 5 + 4)
    assert counts.update_bytes(7, 4, adagrad=False) == 7 * (16 * 3 + 4)


def test_unique_rows_are_counted_over_every_shard():
    cell = tiny_cell(chips=2)
    prog = spec.model("dlrm").Program(cell, SEED, 1, 2, None,
                                      torch.device("cpu"))
    from port_bench import data

    ids = torch.cat([data.shard_ids(cell.config, cell.traffic, SEED, 0, s, 2,
                                    "cpu")[:, 2:4, :] for s in range(2)])
    want = len({(t, int(i)) for t in range(2)
                for i in ids[:, t, :].reshape(-1)})
    assert prog.unique_rows(0) == want


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_classes_by_correlation_and_union(tmp_path):
    X = dict(ph="X", pid=1, tid=1)
    B = dict(ph="X", pid=1, tid=2)  # autograd's thread

    def step(i, ts, dur):
        return {**X, "cat": "user_annotation",
                "name": f"{trace.STEP_TAG}{i}", "ts": ts, "dur": dur}

    def launch(ts, corr, lane=X):
        return {**lane, "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(name, ts, dur, corr, tid=7):
        return {"ph": "X", "pid": 0, "tid": tid, "cat": "kernel",
                "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    ev = [
        step(4, -20, 15), launch(-18, 9), kernel("prev", 60, 30, 9),
        step(5, 0, 50),
        {**X, "cat": "cpu_op", "name": "param_tpu_torch::emb_gather",
         "ts": 0, "dur": 10}, launch(2, 1),
        {**B, "cat": "cpu_op", "name": "aten::addmm", "ts": 20, "dur": 10},
        launch(22, 2, B),
        {**X, "cat": "cpu_op", "name": "aten::add", "ts": 40, "dur": 5},
        launch(41, 3),
        step(6, 60, 10), launch(62, 5),
        kernel("k1", 100, 30, 1),
        kernel("sgemm", 120, 30, 2),
        kernel("ncclDevKernel_SendRecv", 140, 30, 4, tid=8),
        kernel("add", 200, 10, 3),
        kernel("next", 210, 30, 5),
    ]
    ops = trace.device_ops(_trace(tmp_path, ev))
    assert [o.cls for o in ops] == ["other", "emb_lookup", "gemm", "comm",
                                    "other", "other"]
    assert [o.step for o in ops] == [4, 5, 5, -1, 5, 6]
    s = trace.summary(ops, 5, 5)
    # from the end of step 4's last op (90) to the end of step 5's (210):
    # busy [100,170] + [200,210], idle [90,100] + [170,200]
    assert s["window_us"] == 120 and s["busy_us"] == 80
    assert s["class_us"] == {"emb_lookup": 30, "gemm": 30, "other": 10}
    assert s["comm_exposed_us"] == 20  # [150,170] of [140,170]
    assert s["idle_gaps"] == [("idle before aten::add", 30),
                              ("idle before param_tpu_torch::emb_gather",
                               10)]
    assert trace.summary(ops, 7, 8) == {}


def test_interval_arithmetic():
    assert trace.union([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert trace.minus([[0, 10]], [[2, 3], [5, 12]]) == 2 + 2
    assert trace.minus([[0, 10]], []) == 10


# --------------------------------------------------------------- no JAX
FORBIDDEN = {"jax", "jaxlib", "flax", "param_tpu"}


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_what_a_run_loads_holds_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.run, port_bench.worker, port_bench.calibrate\n"
            "import param_tpu_torch.models.dlrm, param_tpu_torch.backend\n"
            "from port_bench.worker import forbidden_modules\n"
            "print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={**os.environ,
                                                     "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------ the entry
def test_run_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "rm8x1m.adagrad.uniform", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rm8x1m.adagrad.uniform",
                                      "tb26.sgd.zipf"])
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    for name, m in line["metrics"].items():
        assert math.isfinite(m["value"]), name
        if name.endswith("roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
