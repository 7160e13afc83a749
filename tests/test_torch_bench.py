"""The port's headline bench (``param_tpu_torch/bench.py``) on the CPU at a
small shape: one JSON line whose value is the root ``bench.py``'s byte
formula over the measured time per lookup, and the lookup it times equals
the reference's sum-pooled take."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from param_tpu.ops.embedding import embedding_bytes as ref_embedding_bytes
from param_tpu_torch import bench
from param_tpu_torch.ops.embedding import embedding_bag, embedding_bytes


def test_bench_prints_one_json_line_by_the_reference_formula(capsys):
    assert bench.main(["--device", "cpu", "--rows", "4096", "--batch", "64",
                       "--iters", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "torch_emb_lookup_bw_4096x128_b64_nnz30"
    assert rec["unit"] == "GB/s"
    d = rec["detail"]
    nbytes = ref_embedding_bytes(64, 30, 128, 4)
    assert d["bytes_per_step"] == nbytes == embedding_bytes(64, 30, 128, 4)
    assert rec["value"] == pytest.approx(nbytes / (d["us_per_step"] * 1e-6)
                                         / 1e9, rel=1e-9)
    assert d["lookups_per_s"] == pytest.approx(64 * 30 / (d["us_per_step"]
                                                          * 1e-6), rel=1e-9)
    assert d["device"] == "cpu" and d["power_limit"] is None
    assert d["max_abs_err"] == 0.0 and "vs_baseline" not in rec
    assert d["us_per_step_min"] <= d["us_per_step"] <= d["us_per_step_max"]


def test_metric_name_at_the_headline_shape():
    assert bench.metric_name(bench.ROWS, bench.BATCH) \
        == "torch_emb_lookup_bw_1Mx128_b8192_nnz30"


def test_the_timed_lookup_is_the_reference_bag():
    """bench.py's step, ``sum(take(table, (idx + i) % E), axis=1)``, on the
    same numpy inputs."""
    rng = np.random.default_rng(0)
    table = rng.random((1000, 128), dtype=np.float32)
    idx = rng.integers(0, 1000, size=(16, 30)).astype(np.int32)
    for i in (0, 3):
        shifted = (idx + i) % 1000
        want = np.asarray(jnp.sum(jnp.take(jnp.asarray(table),
                                           jnp.asarray(shifted), axis=0),
                                  axis=1))
        got = embedding_bag(torch.from_numpy(table),
                            torch.from_numpy(shifted.astype(np.int32)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bench_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--rows", "4096", "--batch", "64"])
