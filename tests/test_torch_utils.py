"""The port's host utilities against ``param_tpu.utils``: the timers and
their profiler regions, the logger helpers, the native data helpers (byte
for byte, with ``libparamdata.so`` and in the numpy fallback) and the
shared constants."""

import logging

import numpy as np
import pytest
import torch

from param_tpu.backend import base as jbase
from param_tpu.comms import harness as jharness
from param_tpu.utils import dtypes as jdtypes
from param_tpu.utils import logger as jlogger
from param_tpu.utils import native as jnative
from param_tpu.utils import timer as jtimer
from param_tpu_torch.backend import base as tbase
from param_tpu_torch.comms import harness as tharness
from param_tpu_torch.utils import dtypes as tdtypes
from param_tpu_torch.utils import logger as tlogger
from param_tpu_torch.utils import native as tnative
from param_tpu_torch.utils import profiler as tprofiler
from param_tpu_torch.utils import timer as ttimer


def _timer_ops(mod):
    """The same operations on a package's ParamTimer / RegionTimers; what
    each reads back."""
    t = mod.ParamTimer()
    t.inc_ns(1500)
    t.inc_ns(2_500_000)
    out = [t.elapsed_ns, t.get_us(), t.get_ms(), t.get_s()]
    t.reset(7)
    out.append(t.elapsed_ns)
    r = mod.RegionTimers()
    r.get("fwd").inc_ns(1000)
    r.get("fwd").inc_ns(500)
    r.get("bwd").inc_ns(2000)
    out.append(r.snapshot_us())
    r.reset_all()
    out.append(r.snapshot_us())
    return out


def test_timers_match_reference():
    got, want = _timer_ops(ttimer), _timer_ops(jtimer)
    assert got == want
    assert want[-2] == {"fwd": 1.5, "bwd": 2.0}


def _profiled_names(body):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("description,name", [("dlrm_fwd", "dlrm_fwd"),
                                              ("", "param_profile")])
def test_param_profile_names_a_region_and_times_it(description, name):
    t = ttimer.ParamTimer()

    def body():
        with ttimer.param_profile(t, description):
            torch.ones(64).sum()

    assert name in _profiled_names(body)
    first = t.elapsed_ns
    assert first > 0
    with ttimer.param_profile(t, description):
        pass
    assert t.elapsed_ns > first
    with ttimer.param_profile(None, description):  # no timer: a region only
        pass


def test_param_profile_adds_time_when_the_body_raises():
    t = ttimer.ParamTimer()
    with pytest.raises(ValueError):
        with ttimer.param_profile(t, "r"):
            raise ValueError("x")
    assert t.elapsed_ns > 0


def test_annotate_names_a_region():
    def body():
        with tprofiler.annotate("my_region"):
            torch.ones(8).sum()

    assert "my_region" in _profiled_names(body)


def test_get_perf_loggers_lists_registered_sinks():
    sink = tlogger.StdoutJsonLogger()
    before = tlogger.get_perf_loggers()
    tlogger.register_perf_logger("_test_sink", sink)
    try:
        assert tlogger.get_perf_loggers() == before + [sink]
    finally:
        tlogger.unregister_perf_logger("_test_sink")
    assert tlogger.get_perf_loggers() == before


def _root_format(setup, rank, level):
    setup(rank=rank, level=level)
    root = logging.getLogger()
    return root.level, [h.formatter._fmt for h in root.handlers]


@pytest.mark.parametrize("rank,level", [(0, "INFO"), (3, "warning")])
def test_setup_rank_logging_matches_reference(rank, level):
    root = logging.getLogger()
    saved = root.level, root.handlers[:]
    try:
        want = _root_format(jlogger.setup_rank_logging, rank, level)
        got = _root_format(tlogger.setup_rank_logging, rank, level)
    finally:
        root.handlers[:] = saved[1]
        root.setLevel(saved[0])
    assert got == want
    assert f"[rank {rank}]" in got[1][0]


@pytest.mark.parametrize("args", [(), ("bad size", 2), ("", 0)])
def test_graceful_exit_matches_reference(args, caplog):
    codes = []
    for mod in (jlogger, tlogger):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            with pytest.raises(SystemExit) as e:
                mod.graceful_exit(*args)
        codes.append((e.value.code, [r.getMessage() for r in caplog.records]))
    assert codes[0] == codes[1]
    assert codes[1][0] == (args[1] if args else 1)


NATIVE_CASES = [(0, 64, 8, (100,)), (7, 1000, 1, (33, 5)),
                (123456789, 4096, 30, (2, 3, 257))]


@pytest.fixture(params=["native", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages with ``libparamdata.so`` loaded, or both with their
    numpy fallback."""
    if request.param == "native":
        assert tnative.get_lib() is not None and jnative.get_lib() is not None
    else:
        monkeypatch.setattr(tnative, "get_lib", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "get_lib", lambda *a, **k: None)
    return request.param


@pytest.mark.parametrize("seed,batch,max_nnz,shape", NATIVE_CASES)
def test_ragged_offsets_and_normal_match_reference_bytes(
        native_mode, seed, batch, max_nnz, shape):
    got = tnative.ragged_offsets(seed, batch, max_nnz)
    want = jnative.ragged_offsets(seed, batch, max_nnz)
    assert got.dtype == want.dtype == np.int64 and got.shape == (batch + 1,)
    assert got.tobytes() == want.tobytes()
    lengths = np.diff(got)
    assert got[0] == 0 and lengths.min() >= 1 and lengths.max() <= max_nnz

    got = tnative.normal(seed, shape)
    want = jnative.normal(seed, shape)
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    assert got.tobytes() == want.tobytes()


def test_zipf_sampler_teardown_is_quiet(monkeypatch):
    """At interpreter teardown the library's free can fail; ``__del__``
    swallows it, as the reference's does."""

    class Gone:
        def pd_zipf_free(self, handle):
            raise AttributeError("library unloaded")

    z = tnative.ZipfSampler(1.2, 100)
    z._handle = 1
    monkeypatch.setattr(tnative, "_lib", Gone())
    z.__del__()
    assert z._handle is None


def test_constants_match_reference():
    assert tdtypes.REDUCE_DTYPES == jdtypes.REDUCE_DTYPES
    assert tbase.SUPPORTED_P2P_OPS == jbase.SUPPORTED_P2P_OPS
    assert tbase.PT2PT_PATTERNS == jbase.PT2PT_PATTERNS
    assert tharness.NEEDS_WORLD == jharness.NEEDS_WORLD
    assert set(tdtypes.REDUCE_DTYPES) <= set(tdtypes.DTYPE_MAP)


def test_cli_comms_pt2pt_choices_are_the_patterns():
    from param_tpu_torch.cli import comms as cli

    ap = cli.build_parser()
    (act,) = [a for a in ap._actions if a.dest == "pt2pt"]
    assert act.choices == [None, *jbase.PT2PT_PATTERNS]
