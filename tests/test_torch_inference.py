"""The port's quantized MLP inference ladder against
``param_tpu.ops.inference``, and its CLI on the CPU.

Both packages start from the reference's ``init_mlp`` weights
(``mlp_params_from_jax``) and the same numpy inputs.  Quantized values and
scales must be equal.  Forwards: rtol 2e-2 at 3 layers (two bf16 ulps:
every layer's output is rounded to bf16 on both sides, so a sum taken in
another order may round one ulp apart and carry on to the next layer); on
this CPU they agree bit for bit.  M = 5 and M = 96 cover both of the
reference's int4 regimes (batched group einsum below M = 64, one
dequantized dot from 64 on).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.ops import inference as jinf
from param_tpu.ops.matmul import pack_int4 as j_pack_int4
from param_tpu.ops.mlp import init_mlp as j_init_mlp
from param_tpu_torch.cli import inference as cli
from param_tpu_torch.models.convert import mlp_params_from_jax
from param_tpu_torch.ops import inference as tinf
from param_tpu_torch.ops.compute_bench import ComputeResult

DIMS = [256, 384, 256, 128]


def _params(dims=DIMS, seed=0):
    jp = j_init_mlp(jax.random.PRNGKey(seed), dims, jnp.float32)
    np_params = [(np.asarray(w), np.asarray(b)) for w, b in jp]
    return jp, mlp_params_from_jax(np_params, device="cpu")


def _x(m, din=DIMS[0], seed=1):
    x = np.random.default_rng(seed).random((m, din), dtype=np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _assert_close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)


def test_mlp_params_from_jax_copies():
    jp, tp = _params()
    for (jw, jb), (tw, tb) in zip(jp, tp):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert not tw.requires_grad


def test_quantize_int8_equal():
    jp, tp = _params()
    for (jq, js, _), (tq, ts, _) in zip(jinf.quantize_weights_int8(jp),
                                        tinf.quantize_weights_int8(tp)):
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("group", [128, 64])
def test_quantize_int4_equal_and_packs_like_pack_int4(group):
    jp, tp = _params()
    tq4 = tinf.quantize_weights_int4(tp, group)
    for (jq, js, _), (tq, ts, _) in zip(jinf.quantize_weights_int4(jp, group),
                                        tq4):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the carriers packed once give the bytes of the reference's pack_int4
    for (w, _), (packed, scale, _) in zip(jp, tinf.pack_int4_mlp(tq4)):
        jpk, jsc = j_pack_int4(w, group)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("m", [5, 96])
def test_forward_int8_matches_reference(m):
    jp, tp = _params()
    jx, tx = _x(m)
    want = jinf.mlp_forward_int8(jinf.quantize_weights_int8(jp), jx)
    got = tinf.mlp_forward_int8(tinf.quantize_weights_int8(tp), tx)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want)


@pytest.mark.parametrize("m", [5, 96])
def test_forward_int4_matches_reference(m):
    jp, tp = _params()
    jx, tx = _x(m)
    jq = jinf.quantize_weights_int4(jp)
    want = jinf.mlp_forward_int4(jinf.cast_int4_mlp(jq), jx)
    tq = tinf.quantize_weights_int4(tp)
    got = tinf.mlp_forward_int4(tinf.cast_int4_mlp(tq), tx)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want)
    # raw carriers are packed on the way, as the reference casts them
    torch.testing.assert_close(tinf.mlp_forward_int4(tq, tx), got, rtol=0,
                               atol=0)


@pytest.mark.parametrize("m,group", [(1, 128), (64, 128), (5, 64), (96, 64)])
def test_cast_int4_mlp_forward_matches_reference(m, group):
    """The once-per-run preparation of both packages feeds their int4
    forward: the reference's s4 cast, the port's packing into K5's layout
    (``pack_int4_mlp`` is the same function)."""
    assert tinf.pack_int4_mlp is tinf.cast_int4_mlp
    jp, tp = _params()
    jx, tx = _x(m)
    want = jinf.mlp_forward_int4(
        jinf.cast_int4_mlp(jinf.quantize_weights_int4(jp, group)), jx)
    tq = tinf.quantize_weights_int4(tp, group)
    cast = tinf.cast_int4_mlp(tq)
    for (q, s, b), (pq, ps, pb) in zip(tq, cast):
        assert pq.shape == (q.shape[0] // 2, q.shape[1])
        assert ps is s and pb is b
    got = tinf.mlp_forward_int4(cast, tx)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "int4"])
def test_bench_inference_formulas(dtype, monkeypatch):
    """Latency, TF/s (2 * sum(l_i * l_i+1) * batch / t), QPS and roofline
    as the reference computes them, from a fixed time."""
    from param_tpu.ops.mlp import mlp_flops as j_mlp_flops
    from param_tpu.utils.chip import CHIPS, matmul_roofline_tflops

    import param_tpu_torch.utils.timer as timer

    monkeypatch.setattr(timer, "time_ms", lambda *a, **k: 2.0)
    (r,) = tinf.bench_inference([(3, 64, 32, 16, 8)], dtype=dtype, iters=1,
                                reps=1, device="cpu")
    assert isinstance(r, ComputeResult) and r.op == "mlp_infer"
    per = 2e-3
    tf = j_mlp_flops([64, 32, 32, 16], 8, fwd_only=True) / per / 1e12
    peak = (CHIPS["cpu"].bf16_tflops if dtype in ("int8", "int4")
            else matmul_roofline_tflops(CHIPS["cpu"], dtype))
    assert r.lat_us == pytest.approx(per * 1e6)
    assert r.tflops == pytest.approx(tf)
    assert r.qps == pytest.approx(8 / per)
    assert r.roofline_frac == pytest.approx(tf / peak)


@pytest.mark.parametrize("dtype", ["int4", "int8", "bfloat16"])
def test_cli_prints_table_on_cpu(dtype, capsys):
    rc = cli.main(["--shape", "2,64,64,64,8", "--dtype", dtype, "--chain", "2",
                   "--reps", "1", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"COMPUTE-RES chip=cpu dtype={dtype}" in out
    rows = [ln for ln in out.splitlines()
            if re.match(r"\s*mlp_infer\s+\(2, 64, 64, 64, 8\)", ln)]
    assert len(rows) == 1
    nums = [float(v) for v in rows[0].split(")")[-1].replace("%", "").split()]
    assert len(nums) == 5 and nums[0] > 0 and nums[3] > 0


def test_cli_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--shape", "2,64,64,64,8", "--dtype", "int4"])
