"""The port's compute tier on the CPU: shape sets, bench formulas and the
compute CLI against ``param_tpu``, and the utilities they use (chip specs,
timer, result sinks, profiler).

The bench formulas are checked from a fixed time (``time_ms`` patched to
2 ms), so each result must equal what the reference's formula gives for
the same shape and time, to float rounding (pytest.approx, rel 1e-6).
"""

import json
import os
import re

import pytest
import torch

import param_tpu_torch.utils.timer as timer
from param_tpu.ops import datasets as jdata
from param_tpu.ops.embedding import embedding_bytes as j_embedding_bytes
from param_tpu.ops.mlp import mlp_flops as j_mlp_flops
from param_tpu.utils.chip import CHIPS, matmul_roofline_tflops as j_roofline
from param_tpu_torch.cli import compute as cli
from param_tpu_torch.ops import compute_bench as cb
from param_tpu_torch.ops import datasets as tdata
from param_tpu_torch.ops.embedding import embedding_bytes
from param_tpu_torch.ops.mlp import mlp_flops
from param_tpu_torch.utils import chip, logger, profiler

T_MS = 2.0
J_CPU = CHIPS["cpu"]


@pytest.fixture
def fixed_time(monkeypatch):
    monkeypatch.setattr(cb, "time_ms", lambda *a, **k: T_MS)


def test_datasets_equal_reference():
    names = sorted(n for n in vars(jdata) if n.isupper())
    assert names == sorted(n for n in vars(tdata) if n.isupper())
    for n in names:
        assert getattr(tdata, n) == getattr(jdata, n), n


@pytest.mark.parametrize("dims,batch", [([1024] * 19, 512), ([4, 8, 2], 3)])
@pytest.mark.parametrize("fwd_only", [True, False])
def test_mlp_flops_equal(dims, batch, fwd_only):
    assert mlp_flops(dims, batch, fwd_only) == j_mlp_flops(dims, batch,
                                                           fwd_only)


def test_embedding_bytes_equal():
    for shape in [(8192, 30, 128, 4), (2048, 34, 56, 2)]:
        assert embedding_bytes(*shape) == j_embedding_bytes(*shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["torch", "kernel", "wres"])
def test_bench_gemm_formulas(dtype, mode, fixed_time):
    shapes = [(32, 64, 48), (100, 100, 100)]
    res = cb.bench_gemm(shapes, dtype=dtype, iters=1, reps=1,
                        use_pallas=mode == "kernel",
                        weight_resident=3 if mode == "wres" else 0,
                        device="cpu")
    per = T_MS / 1e3 / (3 if mode == "wres" else 1)
    for r, (m, n, k) in zip(res, shapes):
        tf = 2 * m * n * k / per / 1e12
        assert (r.op, r.shape) == ("gemm", (m, n, k))
        assert r.lat_us == pytest.approx(per * 1e6)
        assert r.tflops == pytest.approx(tf)
        assert r.roofline_frac == pytest.approx(tf / j_roofline(J_CPU, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_emb_formulas(dtype, fixed_time):
    (r,) = cb.bench_emb([(1000, 16, 4, 64)], dtype=dtype, iters=1, reps=1,
                        device="cpu")
    per = T_MS / 1e3
    gbs = j_embedding_bytes(64, 4, 16, 4 if dtype == "float32" else 2) / per / 1e9
    assert (r.op, r.shape) == ("emb", (1000, 16, 4, 64))
    assert r.gbs == pytest.approx(gbs)
    assert r.qps == pytest.approx(64 / per)
    assert r.roofline_frac == pytest.approx(gbs / J_CPU.hbm_gbs)


def test_bench_emb_clamps_rows(fixed_time):
    (r,) = cb.bench_emb([(5000, 8, 2, 16)], iters=1, reps=1, max_rows=300,
                        distribution="zipf", device="cpu")
    assert r.shape == (300, 8, 2, 16)


@pytest.mark.parametrize("fwd_only,optimizer", [(True, "sgd"), (False, "sgd"),
                                                (False, "adagrad")])
def test_bench_mlp_formulas(fwd_only, optimizer, fixed_time):
    (r,) = cb.bench_mlp([(3, 16, 32, 8, 4)], optimizer=optimizer,
                        fwd_only=fwd_only, iters=1, reps=1, device="cpu")
    per = T_MS / 1e3
    tf = j_mlp_flops([16, 32, 32, 8], 4, fwd_only) / per / 1e12
    assert (r.op, r.shape) == ("mlp", (3, 16, 32, 8, 4))
    assert r.tflops == pytest.approx(tf)
    assert r.qps == pytest.approx(4 / per)
    assert r.roofline_frac == pytest.approx(tf / j_roofline(J_CPU, "float32"))


def test_bench_mlp_train_step_learns(monkeypatch):
    """The timed train step really updates the weights (loss falls)."""
    losses = []

    def run_steps(fn, *a, **k):
        losses.extend(float(fn().detach()) for _ in range(20))
        return T_MS

    monkeypatch.setattr(cb, "time_ms", run_steps)
    cb.bench_mlp([(2, 8, 16, 4, 32)], optimizer="sgd", device="cpu")
    assert losses[-1] < losses[0]


def _table_rows(out, op):
    return [ln for ln in out.splitlines() if re.match(rf"\s*{op}\s+\(", ln)]


@pytest.mark.parametrize("argv,op,n_rows", [
    (["gemm", "--shape", "64,64,64", "--pallas"], "gemm", 1),
    (["gemm", "--shape", "100,100,100"], "gemm", 1),
    (["gemm", "--weight-resident", "4", "--shape", "32,64,48", "--dtype",
      "bfloat16"], "gemm", 1),
    (["emb", "--shape", "1000,16,4,64"], "emb", 1),
    (["linear", "--shape", "3,32,32,16,8"], "mlp", 1),
    (["linear", "--shape", "3,32,32,16,8", "--fwd-only", "--dtype",
      "bfloat16"], "mlp", 1),
])
def test_cli_prints_table_on_cpu(argv, op, n_rows, capsys):
    assert cli.main(argv + ["--chain", "2", "--reps", "1", "--device",
                            "cpu"]) == 0
    out = capsys.readouterr().out
    assert "COMPUTE-RES chip=cpu" in out
    rows = _table_rows(out, op)
    assert len(rows) == n_rows
    assert float(rows[0].split(")")[-1].split()[0]) > 0  # latency


def test_cli_compare_prints_both_paths(capsys):
    assert cli.main(["--device", "cpu", "gemm", "--shape", "64,32,16",
                     "--compare", "--chain", "2", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    paths = re.findall(r"^\s+64\s+32\s+16\s+(\S+)\s+[\d.]+\s+[\d.]+$", out,
                       re.M)
    assert paths == ["torch", "K3"]


@pytest.mark.parametrize("argv,ops", [
    (["attention", "--shape", "1,2,128,64", "--paths", "xla,flash,dpa"],
     ["att:xla", "att:flash", "att:dpa"]),
    (["decode", "--shape", "2,4,2,64,32"], ["decode-gqa"]),
    (["serve", "--shape", "2,64,128,4,256", "--dtype", "int4"],
     ["serve-int4"]),
    (["transformer", "--shape", "2,64,128,4,256", "--fwd-only"],
     ["tf-fwd:flash", "tf-fwd:xla"]),
])
def test_serving_subcommands_on_cpu(argv, ops, capsys):
    assert cli.main(argv + ["--chain", "1", "--reps", "1", "--device",
                            "cpu"]) == 0
    out = capsys.readouterr().out
    assert "COMPUTE-RES chip=cpu" in out
    for op in ops:
        (row,) = _table_rows(out, re.escape(op))
        assert float(row.split(")")[-1].split()[0]) > 0  # latency


@pytest.mark.parametrize("argv,ops", [
    (["transformer", "--shape", "2,64,128,4,256"], ["tf:flash", "tf:xla"]),
    (["attention", "--shape", "1,2,128,64", "--grad", "--paths",
      "xla,flash,dpa"], ["att-grad:xla", "att-grad:flash", "att-grad:dpa"]),
])
def test_training_subcommands_on_cpu(argv, ops, capsys):
    """The training halves: the block's train step (the default of
    ``transformer``) and ``attention --grad``, one row per path."""
    assert cli.main(argv + ["--chain", "1", "--reps", "1", "--device",
                            "cpu"]) == 0
    out = capsys.readouterr().out
    assert "COMPUTE-RES chip=cpu" in out
    for op in ops:
        (row,) = _table_rows(out, re.escape(op))
        assert float(row.split(")")[-1].split()[0]) > 0  # latency


def test_bench_attention_grad_formulas_and_gradients(monkeypatch):
    """attention --grad: 7/2 of the forward's flops, as the reference; each
    timed call returns the gradients of q, k and v, equal on every path."""
    from param_tpu.ops.attention import attention_flops as j_af

    grads = {}

    def run_once(fn, *a, **k):
        grads[len(grads)] = fn()
        return T_MS

    monkeypatch.setattr(cb, "time_ms", run_once)
    res = cb.bench_attention([(1, 2, 64, 32)], dtype="float32",
                             paths=["xla", "flash", "dpa"], grad=True,
                             device="cpu")
    tf = j_af(1, 2, 64, 64, 32, True) * 7 // 2 / (T_MS / 1e3) / 1e12
    assert [r.op for r in res] == ["att-grad:xla", "att-grad:flash",
                                   "att-grad:dpa"]
    for r in res:
        assert r.tflops == pytest.approx(tf)
    for path in (1, 2):
        for got, want in zip(grads[path], grads[0]):
            assert got.shape == (1, 2, 64, 32)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_bench_transformer_train_formulas_and_steps(monkeypatch):
    """transformer (training): flops from transformer_block_flops with
    grad, as the reference; every timed call is a real step on the params
    the last one left (the loss falls)."""
    from param_tpu.ops.compute_bench import transformer_block_flops as j_tbf

    losses = []

    def run_steps(fn, *a, **k):
        losses.extend(float(fn()) for _ in range(4))
        return T_MS

    monkeypatch.setattr(cb, "time_ms", run_steps)
    shape = (2, 32, 64, 2, 128)
    (r,) = cb.bench_transformer([shape], dtype="float32", paths=["flash"],
                                lr=0.1, device="cpu")
    assert r.op == "tf:flash"
    assert r.tflops == pytest.approx(j_tbf(*shape, True, True)
                                     / (T_MS / 1e3) / 1e12)
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


@pytest.mark.parametrize("shape", [(8, 1024, 768, 12, 3072),
                                   (1, 2048, 4096, 32, 11008)])
@pytest.mark.parametrize("causal,grad", [(True, True), (True, False),
                                         (False, False)])
def test_transformer_block_flops_equal(shape, causal, grad):
    from param_tpu.ops.compute_bench import transformer_block_flops as j_tbf
    assert cb.transformer_block_flops(*shape, causal, grad) == \
        j_tbf(*shape, causal, grad)


def test_bench_attention_formulas(fixed_time):
    from param_tpu.ops.attention import attention_flops as j_af
    res = cb.bench_attention([(1, 2, 64, 32)], dtype="float32",
                             paths=["xla", "flash", "dpa"], iters=1, reps=1,
                             device="cpu")
    tf = j_af(1, 2, 64, 64, 32, True) / (T_MS / 1e3) / 1e12
    assert [r.op for r in res] == ["att:xla", "att:flash", "att:dpa"]
    for r in res:
        assert r.tflops == pytest.approx(tf)
        assert r.roofline_frac == pytest.approx(tf / j_roofline(J_CPU,
                                                                "float32"))


@pytest.mark.parametrize("shape", [(2, 4, 64, 32), (2, 4, 2, 64, 32)])
def test_bench_decode_formulas(shape, fixed_time):
    (r,) = cb.bench_decode_attention([shape], iters=1, reps=1, device="cpu")
    b, h_kv, s, d = shape[0], shape[-3], shape[-2], shape[-1]
    gbs = 2 * b * h_kv * s * d * 2 / (T_MS / 1e3) / 1e9
    assert r.op == ("decode" if len(shape) == 4 else "decode-gqa")
    assert r.gbs == pytest.approx(gbs)
    assert r.qps == pytest.approx(b / (T_MS / 1e3))


@pytest.mark.parametrize("masked", [False, True])
def test_decode_attention_matches_reference(masked):
    """The one decode attention both the decode bench and decode_step run;
    with a mask, only the valid cache positions are attended."""
    import jax.numpy as jnp
    import numpy as np

    from param_tpu_torch.ops.attention import decode_attention

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in
               ((2, 2, 3, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    valid = np.arange(40) < (25 if masked else 40)
    logits = jnp.einsum("bkgd,bksd->bkgs", q, k[:, :, valid]) / 4.0
    p = np.asarray(jnp.exp(logits - logits.max(-1, keepdims=True)))
    want = np.einsum("bkgs,bksd->bkgd", p / p.sum(-1, keepdims=True),
                     v[:, :, valid])
    got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(valid) if masked else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_bench_serve_stream_bytes(dtype, fixed_time):
    """Weight + KV bytes per decode step, as the reference counts them."""
    b, cache, e, h, ff = 2, 64, 128, 4, 256
    (r,) = cb.bench_block_decode([(b, cache, e, h, ff)], dtype=dtype, iters=1,
                                 reps=1, device="cpu")
    n_w = e * 3 * e + e * e + 2 * e * ff
    cols = 3 * e + e + ff + e  # output columns of the four weights
    w_bytes = {"bfloat16": 2 * n_w, "int8": n_w + 4 * cols,
               "int4": n_w // 2 + 4 * (n_w // 128)}[dtype]
    kv = 2 * b * h * (e // h) * cache * 2
    assert r.op == ("serve" if dtype == "bfloat16" else f"serve-{dtype}")
    assert r.gbs == pytest.approx((w_bytes + kv) / (T_MS / 1e3) / 1e9)


def test_cli_rejects_unknown_flags():
    with pytest.raises(SystemExit):
        cli.main(["gemm", "--shape", "8,8,8", "--bogus", "--device", "cpu"])


def test_cli_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["gemm", "--shape", "64,64,64", "--pallas"])


def test_cli_profile_writes_trace(tmp_path, capsys):
    d = str(tmp_path / "prof")
    assert cli.main(["--profile", d, "gemm", "--shape", "16,16,16",
                     "--pallas", "--chain", "1", "--reps", "1", "--device",
                     "cpu"]) == 0
    assert os.path.isfile(os.path.join(d, "trace.json"))
    assert "device time not measured" in capsys.readouterr().out


def test_chip_specs():
    assert chip.detect_chip("cpu") is chip.CPU
    h = chip.H100
    assert chip.matmul_roofline_tflops(h, "bfloat16") == 989.0
    assert chip.matmul_roofline_tflops(h, "float16") == 989.0
    assert chip.matmul_roofline_tflops(h, "int8") == 1979.0
    assert chip.matmul_roofline_tflops(h, "float32") == 67.0
    assert h.hbm_gbs == 3350.0
    # the CPU placeholder rates are the reference's, so CPU runs of the two
    # benches print the same roofline column
    assert chip.matmul_roofline_tflops(chip.CPU, "bfloat16") == \
        J_CPU.bf16_tflops
    assert chip.CPU.hbm_gbs == J_CPU.hbm_gbs
    ms, by = chip.bound_ms(3.35e9, 2 * 4096 ** 3, fp32=False)
    assert (by, ms) == ("bytes", pytest.approx(1.0))


def test_f32_attention_is_bounded_at_the_split_tf32_rate():
    """K6 / K7 take f32 products as three TF32 ones: f32 attention's peak is
    TF32 / 3 on the H100 (495 / 3 TF/s), the f32 GEMM's stays the CUDA
    cores' 67; on the CPU placeholder the two agree, as in the reference."""
    h = chip.H100
    assert h.tf32_flops == 495e12
    assert chip.attention_roofline_tflops(h, "float32") == 165.0
    assert chip.attention_roofline_tflops(h, "bfloat16") == 989.0
    assert chip.attention_roofline_tflops(h, "float16") == 989.0
    assert chip.matmul_roofline_tflops(h, "float32") == 67.0
    assert chip.attention_roofline_tflops(chip.CPU, "float32") == \
        chip.matmul_roofline_tflops(chip.CPU, "float32")
    # llama2 width causal: 34.38 GF forward at 165 TF/s
    flops = 4 * 32 * 128 * (2048 * 2049 // 2)
    ms, by = chip.bound_ms(134e6, flops, split_tf32=True)
    assert by == "operations" and ms == pytest.approx(0.2083, abs=1e-4)
    assert chip.bound_ms(134e6, flops)[0] == pytest.approx(0.5131, abs=1e-4)


def test_timer_median_of_windows():
    calls = []
    samples = timer.time_samples(lambda: calls.append(1), 4, "cpu", reps=3)
    assert len(samples) == 3 and len(calls) == 4 + 12  # one untimed window
    assert all(s >= 0 for s in samples)
    assert timer.time_ms(lambda: None, 2, "cpu", warmup=0, reps=5) >= 0


def test_perf_logger_sinks(tmp_path, capsys):
    path = str(tmp_path / "m.jsonl")
    rec = logger.ComputePerfMetrics(op="gemm", dtype="float32",
                                    shape=[1, 2, 3], lat_us=5.0)
    logger.register_perf_logger("file", logger.FileJsonLogger(path))
    logger.register_perf_logger("out", logger.StdoutJsonLogger())
    try:
        logger.emit_metrics(rec)
    finally:
        logger.unregister_perf_logger("file")
        logger.unregister_perf_logger("out")
    logger.emit_metrics(rec)  # no sink left: nothing written
    with open(path) as f:
        line = json.loads(f.read())
    assert line == json.loads(capsys.readouterr().out)
    assert line["type"] == "ComputePerfMetrics" and line["shape"] == [1, 2, 3]


def test_profile_to_is_a_no_op_without_dir(tmp_path):
    with profiler.profile_to(None, "cpu"):
        pass
    assert not os.listdir(tmp_path)
