"""The port's spans and counters (``param_tpu_torch.utils.profiler``) in the
sparse DLRM steps, the two benchmark readers built on them
(``port_bench/metrics/dedup_ms.py``, ``interaction_ms.py``) and the trace
reader's idle-by-span view (``trace.device_trace.span_idle``).

Off (no profiler): nothing is recorded and no ``record_function`` is
entered.  On (a CPU profiler here): the spans tile the step with the
parents the model's notes give, the counters count, and parameters,
accumulators and loss are bitwise those of a run without a profiler.  The
``cuda`` case checks on the card that the children's CUDA-event time
covers ``dlrm.step``'s and that ``dlrm.step`` agrees with the step's own
CUDA-event interval.

    python -m pytest tests/test_torch_spans.py -q
    python -m pytest --noconftest tests/test_torch_spans.py -m cuda   # on the card
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from param_tpu_torch.models.dlrm import DlrmConfig, DlrmModel, init_dlrm_params
from param_tpu_torch.ops.mlp import tree_leaves
from param_tpu_torch.trace import device_trace
from param_tpu_torch.utils import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_tables=4, rows_per_table=64, emb_dim=16, nnz=4, dense_dim=16,
            bot_mlp=[32, 16], top_mlp=[32, 1], batch=64)
STEPS = 2
# span: (count a step, parents) on one device
ONE_DEVICE = {
    "dlrm.step": (1, []),
    "dlrm.lookup": (1, ["dlrm.step"]),
    "dlrm.dense_fwd": (1, ["dlrm.step"]),
    "dlrm.interaction": (2, ["dlrm.dense_bwd", "dlrm.dense_fwd"]),
    "dlrm.dense_bwd": (1, ["dlrm.step"]),
    "dlrm.dense_update": (1, ["dlrm.step"]),
    "dlrm.dedup": (1, ["dlrm.step"]),
    "dlrm.row_update": (1, ["dlrm.step"]),
}
# ids, pooled rows forward, top and bottom dense gradients, loss
EXCHANGES_A_STEP = 5
WORLD_TIMEOUT_S = 120


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((cfg["batch"], cfg["dense_dim"]), dtype=np.float32),
             rng.integers(0, cfg["rows_per_table"],
                          (cfg["batch"], cfg["num_tables"], cfg["nnz"])),
             rng.integers(0, 2, cfg["batch"]).astype(np.float32))
            for _ in range(n)]


def _run(opt, profiled, device="cpu", cfg=TINY, steps=STEPS):
    """``steps`` sparse steps from the same start; (leaves of params and
    accumulators, losses).  With ``profiled``, under a profiler, the record
    emptied when it starts."""
    model = DlrmModel(DlrmConfig(**cfg), device=device)
    params = model.init_params(0)
    acc = model.init_adagrad_state(params)
    step = (model.make_sparse_sgd_step(0.05) if opt == "sgd"
            else model.make_sparse_adagrad_step(0.05))
    batches = [model.place_batch(b) for b in _batches(cfg, steps)]
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
        else None)
    losses = []
    if prof is not None:
        prof.start()
        profiler.reset()
    try:
        for b in batches:
            if opt == "sgd":
                params, loss = step(params, *b)
            else:
                params, acc, loss = step(params, acc, *b)
            losses.append(loss)
    finally:
        if prof is not None:
            prof.stop()
    leaves = tree_leaves(params) + (tree_leaves(acc) if opt == "adagrad"
                                    else [])
    return [x.detach() for x in leaves], losses, prof


@pytest.fixture(autouse=True)
def empty_record():
    profiler.reset()
    yield
    profiler.reset()


# ------------------------------------------------------------------ off
class _NoRecordFunction:
    def __init__(self, *a, **k):
        raise AssertionError("record_function entered without a profiler")


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_off_records_nothing_and_enters_no_record_function(opt, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _NoRecordFunction)
    assert not profiler.recording()
    _run(opt, profiled=False)
    assert profiler.span_totals() == {}
    assert profiler.counter_totals() == {}


# ------------------------------------------------------------------- on
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_spans_tile_the_step_with_their_parents(opt):
    _, _, prof = _run(opt, profiled=True)
    spans = profiler.span_totals()
    assert set(spans) == set(ONE_DEVICE)
    for name, (per_step, parents) in ONE_DEVICE.items():
        assert spans[name]["count"] == per_step * STEPS, name
        assert spans[name]["parents"] == parents, name
        assert 0 <= spans[name]["self_device_ms"] <= spans[name]["device_ms"]
    # each span is also a range of the profiler's trace
    names = [e.name for e in prof.events()]
    for name, (per_step, _) in ONE_DEVICE.items():
        assert names.count(name) == per_step * STEPS, name


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_recording_leaves_the_step_bitwise(opt):
    off, loss_off, _ = _run(opt, profiled=False)
    on, loss_on, _ = _run(opt, profiled=True)
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    for a, b in zip(loss_off, loss_on):
        assert torch.equal(a, b)


def test_unique_rows_counter_is_the_distinct_ids():
    _run("adagrad", profiled=True)
    counters = profiler.counter_totals()
    want = 0
    for _, idx, _ in _batches(TINY, STEPS):
        flat = idx + np.arange(TINY["num_tables"])[None, :, None] \
            * TINY["rows_per_table"]
        want += torch.unique(torch.from_numpy(flat).reshape(-1)).numel()
    assert counters["dlrm.unique_rows"] == want
    assert counters["dlrm.lookups"] == STEPS * TINY["batch"] * \
        TINY["num_tables"] * TINY["nnz"]
    assert want < counters["dlrm.lookups"]  # the batches repeat rows


def test_count_adds_host_ints_and_device_scalars():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiler.count("a", 3)
        profiler.count("a", torch.tensor(4))
        profiler.count("b", torch.tensor(2))
        profiler.count("b", torch.tensor(5))
    profiler.count("a", 100)  # no profiler: not counted
    assert profiler.counter_totals() == {"a": 7, "b": 7}


def test_self_time_of_nested_spans():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.annotate("outer"):
            time.sleep(0.002)
            with profiler.annotate("inner"):
                time.sleep(0.004)
                with profiler.annotate("leaf"):
                    time.sleep(0.002)
            with profiler.annotate("inner"):
                time.sleep(0.002)
    s = profiler.span_totals()
    assert s["outer"]["count"] == 1 and s["inner"]["count"] == 2
    assert s["inner"]["parents"] == ["outer"]
    assert s["leaf"]["parents"] == ["inner"]
    for name, children in (("outer", ["inner"]), ("inner", ["leaf"]),
                           ("leaf", [])):
        want = s[name]["device_ms"] - sum(s[c]["device_ms"] for c in children)
        assert s[name]["self_device_ms"] == pytest.approx(want, abs=1e-9)
    assert s["outer"]["self_device_ms"] >= 2.0
    assert s["inner"]["self_device_ms"] >= 6.0
    # children that overlap (other streams) count once
    assert profiler._covered([(0, 2), (1, 3), (5, 6), (5.5, 5.8)]) == 4


def test_a_child_left_open_closes_with_its_parent():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.annotate("outer"):
            profiler.annotate("dangling").open()
        with profiler.annotate("next"):
            pass
    s = profiler.span_totals()
    assert s["dangling"]["parents"] == ["outer"]
    assert s["next"]["parents"] == []


# --------------------------------------------------------------- readers
def _reader(name):
    path = os.path.join(ROOT, "port_bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"spans_reader_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["dedup_ms", "interaction_ms"])
def test_reader_is_none_on_an_empty_record(name):
    mod = _reader(name)
    assert mod.NAME == name and mod.UNIT == "ms"
    assert mod.LAYER == "ops: dedup, optimizers, interaction"
    assert mod.MOVES == "samples_per_s"
    assert mod.read({"ranks": []}) is None


@pytest.mark.parametrize("name", ["dedup_ms", "interaction_ms"])
def test_reader_is_none_on_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(profiler, "span_trees")
    assert _reader(name).read({"ranks": []}) is None


@pytest.mark.parametrize("name,want", [("dedup_ms", 2.5),
                                       ("interaction_ms", 1.5)])
def test_reader_gives_the_median_ms_a_step(name, want, monkeypatch):
    """The median over the steps: the first profiled step's stall (20 ms)
    does not move it."""
    steps = [{"dlrm.step": 30.0, "dlrm.dedup": 2.5, "dlrm.interaction": 1.5}
             for _ in range(4)]
    steps[0] = {"dlrm.step": 50.0, "dlrm.dedup": 22.5,
                "dlrm.interaction": 21.5}
    monkeypatch.setattr(profiler, "span_trees",
                        lambda root: steps if root == "dlrm.step" else [])
    assert _reader(name).read({"ranks": []}) == pytest.approx(want)


@pytest.mark.parametrize("name,span", [("dedup_ms", "dlrm.dedup"),
                                       ("interaction_ms", "dlrm.interaction")])
def test_reader_on_a_recorded_run(name, span):
    _run("adagrad", profiled=True, steps=3)
    trees = profiler.span_trees("dlrm.step")
    assert len(trees) == 3
    got = _reader(name).read({"ranks": []})
    assert got == pytest.approx(sorted(t[span] for t in trees)[1]) and got > 0
    s = profiler.span_totals()
    assert sum(t[span] for t in trees) == pytest.approx(s[span]["device_ms"])


def test_span_trees_are_bounded(monkeypatch):
    monkeypatch.setattr(profiler, "TREES_KEPT", 3)
    profiler._RECORD.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(5):
            with profiler.annotate("root"):
                with profiler.annotate("leaf"):
                    pass
    assert len(profiler.span_trees("root")) == 3
    assert profiler.span_totals()["root"]["count"] == 5
    assert set(profiler.span_trees("root")[0]) == {"root", "leaf"}
    assert profiler.span_trees("leaf") == []


# ------------------------------------------------------ trace idle view
def _ev(cat, name, ts, dur, pid=0, tid=7, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_idle_on_a_synthetic_trace():
    """Extents from the ops launched, from any thread, while a span's host
    range was open: ``dlrm.interaction``'s kernel launches from another
    thread (autograd's), ``dlrm.step`` has no kernel of its own outside its
    children, and Kineto's ``gpu_user_annotation`` is not read."""
    main, other = dict(pid=100, tid=1), dict(pid=100, tid=2)
    events = [
        # device (pid 0): k5 overlaps k4 on another stream; the copy lies
        # outside every span
        _ev("kernel", "k1", 0, 10, corr=1), _ev("kernel", "k2", 12, 18, corr=2),
        _ev("kernel", "k3", 30, 5, corr=3), _ev("kernel", "k7", 35, 3, corr=7),
        _ev("kernel", "k4", 45, 55, corr=4),
        _ev("kernel", "k5", 50, 10, tid=8, corr=5),
        _ev("gpu_memcpy", "copy", 150, 10, corr=6),
        _ev("gpu_user_annotation", "dlrm.dense_bwd", 0, 1),
        # host ranges, the ops open at the launches, the launches
        _ev("user_annotation", "port_bench.step.3", -1, 80, **main),
        _ev("user_annotation", "dlrm.step", 0, 60, **main),
        _ev("user_annotation", "dlrm.lookup", 1, 8, **main),
        _ev("user_annotation", "dlrm.interaction", 21, 7, **other),
        _ev("user_annotation", "dlrm.dedup", 30, 20, **main),
        _ev("cpu_op", "aten::mm", 4, 2, **main),
        _ev("cpu_op", "aten::outer", 29, 10, **main),
        _ev("cpu_op", "aten::sort", 31, 4, **main),
    ] + [_ev("cuda_runtime", "cudaLaunchKernel", t, 0.5, corr=c,
             **(other if c == 7 else main))
         for c, t in ((1, 2), (2, 5), (3, 20), (4, 32), (5, 40), (6, 70),
                      (7, 22))]
    out = device_trace.span_idle(events)
    assert out["busy_us"] == 101 and out["device_ops"] == 7
    assert out["spans"] == {
        "dlrm.step": dict(count=1, extent_us=100, busy_us=91, idle_us=9),
        "dlrm.lookup": dict(count=1, extent_us=30, busy_us=28, idle_us=2),
        "dlrm.interaction": dict(count=1, extent_us=3, busy_us=3, idle_us=0),
        "dlrm.dedup": dict(count=1, extent_us=55, busy_us=55, idle_us=0)}
    assert out["gaps"] == [
        {"us": 7, "span": "dlrm.step", "before": "aten::sort"},
        {"us": 2, "span": "dlrm.lookup", "before": "aten::mm"}]
    assert device_trace.span_idle(events, top=1)["gaps"] == out["gaps"][:1]


# ------------------------------------------------- two ranks on gloo
def test_exchange_spans_in_a_world_of_two(tmp_path):
    """The exchange's five collectives a step, each a ``dlrm.exchange`` in
    ``dlrm.step``, on both ranks of a gloo world (tests/torch_dlrm_worker.py
    in its spans mode)."""
    cfg = dict(TINY, rows_per_table=512)
    full = init_dlrm_params(0, DlrmConfig(**cfg), "cpu")
    params = {"tables": full["tables"].numpy(),
              **{k: [(w.numpy(), b.numpy()) for w, b in full[k]]
                 for k in ("bot", "top")}}
    in_file = str(tmp_path / "inputs.pkl")
    with open(in_file, "wb") as f:
        pickle.dump(dict(cfg=cfg, params=params,
                         batches=_batches(cfg, STEPS)), f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dlrm_worker.py"),
         str(tmp_path / "store"), str(r), "2", in_file, str(tmp_path),
         "spans"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=WORLD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    want = dict(ONE_DEVICE, **{"dlrm.exchange": (EXCHANGES_A_STEP,
                                                 ["dlrm.step"])})
    for r in range(2):
        res = torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
        for opt, (spans, counters) in res.items():
            assert set(spans) == set(want), (r, opt)
            for name, (per_step, parents) in want.items():
                assert spans[name]["count"] == per_step * STEPS, (r, opt, name)
                assert spans[name]["parents"] == parents, (r, opt, name)
            # this rank's two tables, every rank's rows
            assert counters["dlrm.lookups"] == STEPS * cfg["batch"] * \
                cfg["num_tables"] // 2 * cfg["nnz"]


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_spans_cover_the_step_on_the_card():
    """On the card, at a size where the device and not the host sets the
    step: the children's CUDA-event time covers at least 97% of
    ``dlrm.step``'s, and ``dlrm.step`` is within 3% of the step's interval
    between CUDA events at consecutive step ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(num_tables=8, rows_per_table=1_000_000, emb_dim=64, nnz=100,
               dense_dim=512, bot_mlp=[512, 64], top_mlp=[1024, 1],
               batch=16384)
    model = DlrmModel(DlrmConfig(**cfg), device="cuda")
    params = model.init_params(0)
    acc = model.init_adagrad_state(params)
    step = model.make_sparse_adagrad_step(0.01)
    batches = [model.place_batch(b) for b in _batches(cfg, 2)]
    for i in range(3):
        step(params, acc, *batches[i % 2])
    n = 6
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        profiler.reset()
        ends[0].record()
        for i in range(n):
            step(params, acc, *batches[i % 2])
            ends[i + 1].record()
        torch.cuda.synchronize()
    s = profiler.span_totals()
    interval = sum(a.elapsed_time(b) for a, b in zip(ends, ends[1:]))
    whole = s["dlrm.step"]
    assert whole["count"] == n
    assert whole["device_ms"] - whole["self_device_ms"] >= \
        0.97 * whole["device_ms"]
    assert abs(whole["device_ms"] - interval) <= 0.03 * interval
    assert s["dlrm.interaction"]["count"] == 2 * n
    assert profiler.counter_totals()["dlrm.unique_rows"] > 0
