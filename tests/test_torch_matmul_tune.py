"""The port's K3 schedule tuner (``param_tpu_torch.ops.matmul_tune``) and
K3's ``schedule=`` argument, on the CPU: the model against the JAX
package's (``param_tpu.ops.matmul_tune``) where their terms coincide, the
candidates' legality and order, the refusals, and a CPU tuning run (the
plain version timed under each checked schedule)."""

import math

import pytest
import torch

from param_tpu.ops import matmul_tune as J
from param_tpu.utils.chip import ChipSpec as JaxChipSpec
from param_tpu_torch.kernels.gemm import (
    _PATHS, GemmSchedule, check_schedule, default_schedule, gemm, gemm_plain,
    k_split,
)
from param_tpu_torch.ops import matmul_tune as T
from param_tpu_torch.utils.chip import H100

# H100's peaks and bandwidth in the JAX package's spec
H100_JAX = JaxChipSpec("h100", H100.bf16_flops / 1e12, H100.fp32_flops / 1e12,
                       H100.hbm_bytes_per_s / 1e9, 80.0, 450.0)


@pytest.mark.parametrize("m,n,k,bm,bn,dtsize,sms", [
    (4096, 4096, 4096, 512, 512, 2, 64),     # compute-bound, 1 wave
    (4096, 8192, 1024, 1024, 512, 2, 16),    # 4 whole waves
    (512, 4096, 8192, 512, 512, 2, 8),       # load-bound
    (2048, 2048, 2048, 512, 1024, 4, 8),     # f32
    (1024, 16384, 256, 512, 2048, 2, 8),     # store-heavy
])
def test_model_equals_jax_at_one_split_whole_waves_large_blocks(
        m, n, k, bm, bn, dtsize, sms):
    """One split (no workspace), whole waves (fill 1) and blocks >= 512
    (the JAX derate 1): the same compute, load and store terms."""
    assert (m // bm) * (n // bn) % sms == 0
    got = T.estimate_matmul_time_us(m, n, k, bm, bn, 512, dtsize, H100,
                                    splits=1, sms=sms)
    want = J.estimate_matmul_time_us(m, n, k, bm, bn, 512, dtsize, H100_JAX)
    assert got == pytest.approx(want, rel=1e-12)


def test_model_adds_the_last_wave_and_the_workspace():
    m, n, k = 128, 1024, 1024
    one = T.estimate_matmul_time_us(m, n, k, 128, 256, 64, 2, splits=1)
    # 4 tiles on 132 SMs: compute over 4/132 of a wave
    assert one == pytest.approx(
        2 * m * n * k / H100.bf16_flops * 1e6 * 132 / 4
        + m * n * 2 / H100.hbm_bytes_per_s * 1e6)
    four = T.estimate_matmul_time_us(m, n, k, 128, 256, 64, 2, splits=4)
    loads = (m * k * 4 + k * n) * 2 / H100.hbm_bytes_per_s * 1e6
    assert four == pytest.approx(
        max(2 * m * n * k / H100.bf16_flops * 1e6 * 132 / 16, loads)
        + m * n * 2 / H100.hbm_bytes_per_s * 1e6
        + 2 * 4 * m * n * 4 / H100.hbm_bytes_per_s * 1e6)
    assert four < one


SHAPES = [
    (2048, 4096, 4096, torch.bfloat16, True),
    (1024, 1024, 4096, torch.float32, True),
    (128, 1024, 1024, torch.bfloat16, True),
    (100, 100, 100, torch.bfloat16, False),
    (100, 100, 100, torch.float32, False),
    (7, 9, 1, torch.float16, False),
    (64, 64, 0, torch.bfloat16, True),
    (64, 64, 8, torch.bfloat16, True),
]


@pytest.mark.parametrize("m,n,k,dtype,aligned", SHAPES)
def test_candidates_are_legal_ranked_and_never_empty(m, n, k, dtype, aligned):
    cands = T.candidate_blocks(m, n, k, dtype, aligned, top=1000)
    assert cands
    for c in cands:
        assert check_schedule(c.schedule(), m, n, k, dtype, aligned) == \
            c.schedule()
        if dtype == torch.float32:
            assert c.path == "simt"
        else:
            assert c.path != "simt"
            assert aligned and k > 0 or c.path == "mma_sync"
        if c.path == "mma_sync":
            assert c.splits == 1
        bk = _PATHS[c.path][1][2]
        assert c.splits == 1 or (c.splits - 1) * k_split(k, bk, c.splits) < k
    ests = [c.est_us for c in cands]
    assert all(round(a, 3) <= round(b, 3) for a, b in zip(ests, ests[1:]))
    assert len({c.schedule() for c in cands}) == len(cands)
    assert T.candidate_blocks(m, n, k, dtype, aligned) == cands[:5]


@pytest.mark.parametrize("m,n,k,dtype,aligned", SHAPES)
def test_default_schedule_is_a_legal_candidate(m, n, k, dtype, aligned):
    d = default_schedule(m, n, k, dtype, aligned, 132)
    assert check_schedule(d, m, n, k, dtype, aligned) == d
    assert d in [c.schedule() for c in
                 T.candidate_blocks(m, n, k, dtype, aligned, top=1000)]


@pytest.mark.parametrize("schedule,dtype,aligned,k,match", [
    (("simt", 1, False), torch.bfloat16, True, 64, "does not take"),
    (("wgmma", 1, False), torch.float32, True, 64, "does not take"),
    (("mma_sync", 1, False), torch.float32, True, 64, "does not take"),
    (("wgmma", 1, False), torch.bfloat16, False, 64, "TMA"),
    (("wgmma", 1, False), torch.bfloat16, True, 0, "TMA"),
    (("mma_sync", 2, False), torch.bfloat16, True, 64, "one K split"),
    (("simt", 0, False), torch.float32, True, 64, r"\[1, 65535\]"),
    (("simt", 65536, False), torch.float32, True, 2**21, r"\[1, 65535\]"),
    (("simt", 1.5, False), torch.float32, True, 64, r"\[1, 65535\]"),
    (("wgmma", 2, False), torch.bfloat16, True, 64, "empty"),
    (("simt", 4, False), torch.float32, True, 80, "empty"),
    (("tensor_core", 1, False), torch.bfloat16, True, 64, "unknown"),
])
def test_schedule_refusals(schedule, dtype, aligned, k, match):
    with pytest.raises(ValueError, match=match):
        check_schedule(schedule, 128, 128, k, dtype, aligned)


def test_schedule_refused_on_cpu_before_the_plain_version():
    a = torch.randn(64, 48, dtype=torch.bfloat16)
    b = torch.randn(48, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gemm(a, b, schedule=("simt", 1, False))
    with pytest.raises(ValueError):
        gemm(a.float(), b.float(), schedule=GemmSchedule("simt", 4))
    got = gemm(a, b, schedule=GemmSchedule("wgmma", 1, True))
    torch.testing.assert_close(got, gemm_plain(a, b), rtol=0, atol=0)
    got = gemm(a, b, torch.float32, schedule=("mma_sync", 1, False))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, gemm_plain(a, b, torch.float32))


def test_tune_matmul_on_cpu():
    a = torch.randn(128, 256, dtype=torch.bfloat16)
    b = torch.randn(256, 64, dtype=torch.bfloat16)
    best, med = T.tune_matmul(a, b, reps=2, iters=2)
    dflt = default_schedule(128, 64, 256, torch.bfloat16, True, 132)
    assert dflt in med and best in med
    assert med[best] == min(med.values())
    assert all(math.isfinite(v) and v > 0 for v in med.values())
    assert len(med) >= 3
    best, med = T.tune_matmul(a.float(), b.float(),
                              candidates=[("simt", 1, False), ("simt", 2, True)],
                              reps=1, iters=1)
    assert set(med) == {GemmSchedule("simt", 1, False),
                        GemmSchedule("simt", 2, True)}
    with pytest.raises(ValueError):
        T.tune_matmul(a, b, candidates=[("simt", 1, False)], reps=1, iters=1)
