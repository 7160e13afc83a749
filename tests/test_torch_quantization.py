"""The port's quantized collectives against the reference:
``quantize`` / ``dequantize`` / ``check_quant_args`` bitwise in this
process, then the quantized ``all_reduce`` and ``reduce`` at 8 and 16 bits
(odd element counts, a 2-D input, and reductions that ignore the bitwidth)
in spawned gloo worlds of 2 and 4 (tests/torch_remainder_worker.py, no JAX
in the children) against ``TpuBackend`` on a CPU mesh of the same size fed
the same inputs, and the harness's ``--bitwidth`` path (dcheck, busBW x
bitwidth / 32, ``quant_us``).

Tolerances: one quantization step (max |result| / 127) at 8 bits, rtol
1e-2 at 16 bits (the reference's own tests' bound for a bf16 sum), exact
for the reductions that ignore the bitwidth.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.backend import TpuBackend
from param_tpu.backend.base import CollectiveArgs as RefArgs
from param_tpu.comms import quantization as ref_q
from param_tpu_torch.backend import CollectiveArgs, DistBackend
from param_tpu_torch.cli import comms as cli
from param_tpu_torch.comms import quantization as q

import torch_remainder_worker as worker

WORLDS = (2, 4)


# ------------------------------------------------ quantize, bitwise
def _inputs():
    rng = np.random.default_rng(3)
    return {
        "normal": rng.standard_normal(257).astype(np.float32),
        "wide": (rng.standard_normal((6, 5)) * 1e3).astype(np.float32),
        "zeros": np.zeros(16, np.float32),
        # x / scale lands on k + 0.5 exactly: half to even in both
        "halves": np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5],
                           np.float32),
        "tiny": (rng.random(33) * 1e-30).astype(np.float32),
    }


@pytest.mark.parametrize("bitwidth", [8, 16, 32])
@pytest.mark.parametrize("name", sorted(_inputs()))
def test_quantize_dequantize_bitwise(name, bitwidth):
    x = _inputs()[name]
    want_q, want_s = ref_q.quantize(jnp.asarray(x), bitwidth)
    got_q, got_s = q.quantize(torch.from_numpy(x), bitwidth)
    want_q = np.asarray(want_q.astype(jnp.float32))
    np.testing.assert_array_equal(got_q.float().numpy(), want_q)
    assert got_q.dtype == {8: torch.int8, 16: torch.bfloat16,
                           32: torch.float32}[bitwidth]
    assert got_s.item() == float(want_s) and got_s.dtype == torch.float32
    want = np.asarray(ref_q.dequantize(ref_q.quantize(jnp.asarray(x),
                                                      bitwidth)[0], want_s))
    got = q.dequantize(got_q, got_s).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_rejects_other_bitwidths():
    with pytest.raises(ValueError, match="unsupported bitwidth"):
        q.quantize(torch.ones(4), 4)


@pytest.mark.parametrize("coll", sorted(ref_q.QUANTIZABLE) + [
    "broadcast", "gather", "pt2pt", "all_gather_v"])
@pytest.mark.parametrize("bitwidth", [32, 16, 8, 4])
def test_check_quant_args_matches_reference(coll, bitwidth):
    def outcome(fn):
        try:
            fn(coll, bitwidth)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(q.check_quant_args) == outcome(ref_q.check_quant_args)
    assert q.QUANTIZABLE == ref_q.QUANTIZABLE
    assert q.SUPPORTED_BITWIDTHS == ref_q.SUPPORTED_BITWIDTHS


# ------------------------------------------------------- world of 1
@pytest.fixture
def world1():
    b = DistBackend("cpu")
    b.initialize()
    yield b
    b.shutdown()


@pytest.mark.parametrize("bitwidth", [8, 16])
def test_world_1_is_the_round_trip(world1, bitwidth):
    """In a world of one the quantized all-reduce is the quantize ->
    dequantize round trip: once at 16 bits, twice at 8 (phase 1, then the
    reduced chunk's); the quantized reduce is one round trip."""
    x = torch.from_numpy(_inputs()["normal"])
    got = world1.all_reduce(CollectiveArgs(in_tensor=x, bitwidth=bitwidth))
    once = q.dequantize(*q.quantize(x, bitwidth))
    want = once if bitwidth == 16 else q.dequantize(*q.quantize(once, 8))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    red = world1.reduce(CollectiveArgs(in_tensor=x, bitwidth=bitwidth))
    torch.testing.assert_close(red, x, rtol=0, atol=0)  # no hop, no cast
    over = world1.quant_overhead(CollectiveArgs(in_tensor=x,
                                                bitwidth=bitwidth))
    torch.testing.assert_close(over, once, rtol=0, atol=0)


def test_cli_bitwidth_world_1(capsys, tmp_path):
    metrics = str(tmp_path / "m.jsonl")
    assert cli.main(["--device", "cpu", "--collective",
                     "all_reduce,reduce,all_gather", "--bitwidth", "8",
                     "--b", "1K", "--e", "2K", "--n", "2", "--w", "1",
                     "--c", "1", "--output-json", metrics]) == 0
    out = capsys.readouterr().out
    assert out.count("COMMS-RES:") == 3 and "BAD" not in out
    assert out.count("  OK") == 6
    import json

    recs = [json.loads(ln) for ln in open(metrics)]
    assert len(recs) == 6
    assert all(r["quant"]["bitwidth"] == 8 and r["quant"]["quant_us"] > 0
               for r in recs)


# ------------------------------------------------------- spawned worlds
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return worker.run_worlds("quant", WORLDS, tmp_path_factory)


_CASES = [(n, c) for n in WORLDS for c in worker.QUANT_CASES]


@pytest.mark.parametrize("n,case", _CASES,
                         ids=[f"{c[0]}-world{n}" for n, c in _CASES])
def test_quantized_collective_matches_tpu_backend(worlds, n, case):
    name, coll, kw, shape = case
    ref = TpuBackend(devices=jax.devices()[:n])
    ref.initialize()
    x = ref.alloc_per_rank(lambda r: worker.quant_inputs(name, n, shape)[r])
    want = ref.local_shards(ref.collective_fn[coll](RefArgs(in_tensor=x,
                                                            **kw)))
    exact = kw.get("red_op", "sum") != "sum"
    for r in range(n):
        got = worlds[n][r][name].numpy()
        w = np.asarray(want[r]).reshape(got.shape)
        assert worlds[n][r][f"untouched:{name}"], "the input was changed"
        if exact:
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=0,
                                       err_msg=f"rank {r}")
        elif kw["bitwidth"] == 16:
            np.testing.assert_allclose(got, w, rtol=1e-2, atol=0,
                                       err_msg=f"rank {r}")
        else:
            step = np.abs(w).max() / 127.0
            np.testing.assert_allclose(got, w, rtol=0, atol=step * 1.0001,
                                       err_msg=f"rank {r}")
        if coll == "reduce" and r != kw.get("dst_rank", 0):
            assert not got.any(), f"rank {r} is not the root: zeros"


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("bw", [8, 16])
def test_harness_bitwidth_path(worlds, n, bw):
    """dcheck OK through the quantized path or cast payload, busBW scaled
    by bitwidth / 32 (algBW x the bus factor x bw / 32), quant_us set."""
    from param_tpu_torch.utils.bw import bus_bw_factor

    for r in range(n):
        for coll in worker.QUANT_HARNESS:
            ok, quant_us, bus, alg = worlds[n][r][f"harness:{coll}:{bw}"]
            assert ok is True, (coll, r)
            assert quant_us is not None and math.isfinite(quant_us)
            assert bus == pytest.approx(alg * bus_bw_factor(coll, n)
                                        * bw / 32.0, rel=1e-12)
