"""The port's analytic scaling model (``param_tpu_torch.trace.
scaling_model``) on H100 NVSwitch nodes, on the CPU.

- Parity: every collective the two packages model alike (the ring rows,
  gather / scatter and barrier) predicts the same time as the JAX
  package's ``predict_collective_us`` at worlds 2-64, on a JAX
  ``Topology`` built here with the H100 numbers (a node is a closed ring
  of its GPUs; whole nodes beyond 8), through the same DCN composition.
- The switch rows, the port's own: all_to_all and pt2pt against their
  closed forms.
- The H100 constants, pinned with their public source.
- The compute roofline against this repo's measured H100 rows (PERF.md,
  NVIDIA H100 80GB HBM3 at 700 W).  A roofline is a lower bound: every
  prediction is at most the measured time; the tolerance is 25% of the
  measured time where the plain roofline reaches it, and where it does
  not the test says so (no hidden factor is fitted).
- The trace-level sweep and its report.
"""

import json
import math

import pytest

from param_tpu.trace import scaling_model as ref
from param_tpu_torch.trace import scaling_model as sm
from param_tpu_torch.trace.comms_trace import CommsOp

H100 = sm.GENERATIONS["h100"]
WORLDS = [2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 64]
SIZES = [8, 4096, 1 << 20, 64 << 20]
SHARED = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
          "reduce", "gather", "scatter", "barrier", "all_gather_base",
          "reduce_scatter_v", "incast", "multicast"]


def _ref_topology(n):
    """The JAX package's Topology with the H100 numbers: an 8-GPU node is
    a wrapped 1-D ring, one-way 225 GB/s a direction."""
    gen = ref.GenSpec("h100", ici_gbs=225.0, pod_shape=(8,),
                      chips_per_host=8, dcn_gbs_per_host=400.0,
                      hop_latency_us=1.0, mxu_tflops_bf16=989.0,
                      hbm_gbs=3350.0, gather_rows_per_s=163840 / 0.0174e-3)
    pods = max(1, n // 8)
    per = n if pods == 1 else 8
    return ref.Topology(gen=gen, torus=(per,), wrap=(per > 1,), n_pods=pods)


@pytest.mark.parametrize("name", SHARED)
@pytest.mark.parametrize("bitwidth", [32, 16])
def test_shared_rows_match_the_reference(name, bitwidth):
    for n in WORLDS:
        topo, rtopo = sm.slice_topology("h100", n), _ref_topology(n)
        assert topo.total_bw == rtopo.total_bw
        assert topo.n_gpus == rtopo.n_chips == n
        for size in SIZES:
            got = sm.predict_collective_us(name, size, topo, bitwidth)
            want = ref.predict_collective_us(name, size, rtopo, bitwidth)
            assert got == pytest.approx(want, rel=1e-12), (n, size)


@pytest.mark.parametrize("n", WORLDS)
def test_switch_all_to_all_closed_form(n):
    topo = sm.slice_topology("h100", n)
    per, pods = min(n, 8), max(1, n // 8)
    for size in SIZES:
        node = size * (per - 1) / per / 450.0 / 1e3 + (per - 1) * 1.0
        net = size * (pods - 1) / 50.0 / 1e3
        got = sm.predict_collective_us("all_to_allv", size, topo)
        assert got == pytest.approx(node + net, rel=1e-12)
        # on a switch an all_to_all costs what an all_gather costs
        assert got == pytest.approx(
            sm.predict_collective_us("all_gather", size, topo), rel=1e-12)


def test_switch_pt2pt_closed_form():
    for n in (2, 8):
        topo = sm.slice_topology("h100", n)
        assert sm.predict_collective_us("send", 1 << 30, topo) == \
            pytest.approx((1 << 30) / 450.0 / 1e3 + 1.0)
    topo = sm.slice_topology("h100", 16)
    assert sm.predict_collective_us("pt2pt", 1 << 30, topo) == \
        pytest.approx((1 << 30) / 450.0 / 1e3 + 1.0 + (1 << 30) / 50.0 / 1e3)


def test_h100_constants():
    """NVIDIA's H100 SXM data sheet: NVLink-4, 18 links x 25 GB/s one way
    (900 GB/s both ways), 989 TF/s dense bf16, 67 TF/s f32, 3.35 TB/s HBM;
    NVIDIA DGX H100: one 400 Gb/s ConnectX-7 NIC a GPU, 8 GPUs a node.
    K1's rows / s: 163,840 rows in 0.0174 ms (PERF.md, measured on one
    NVIDIA H100 80GB HBM3, 700 W)."""
    assert 2 * H100.link_gbs == 18 * 25.0 == 450.0
    assert H100.node_size == H100.gpus_per_host == 8
    assert H100.dcn_gbs_per_host / H100.gpus_per_host == 400 / 8 == 50.0
    assert (H100.tflops_bf16, H100.tflops_f32, H100.hbm_gbs) == \
        (989.0, 67.0, 3350.0)
    assert H100.gather_rows_per_s == pytest.approx(9.416e9, rel=1e-3)
    topo = sm.slice_topology("h100", 8)
    assert topo.total_bw == 450.0
    assert topo.dcn_bw_per_gpu == 50.0


def test_large_message_busbw_approaches_nvlink():
    for n in (2, 4, 8):
        bw = sm.predicted_bus_bw("all_reduce", 1 << 34,
                                 sm.slice_topology("h100", n))
        assert bw == pytest.approx(450.0, rel=1e-3)


def test_worlds_beyond_a_node_are_whole_nodes():
    topo = sm.slice_topology("h100", 64)
    assert (topo.node_gpus, topo.n_nodes, topo.layout()) == (8, 8, "8*8n")
    with pytest.raises(ValueError, match="whole number"):
        sm.slice_topology("h100", 12)
    assert sm.predict_collective_us("all_reduce", 1 << 20,
                                    sm.slice_topology("h100", 1)) == 0.0


def test_overrides():
    topo = sm.slice_topology("h100", 8, link_gbs=100.0, hop_latency_us=2.0,
                             dcn_gbs_per_host=800.0)
    assert topo.total_bw == 200.0
    assert topo.gen.hop_latency_us == 2.0
    assert topo.dcn_bw_per_gpu == 100.0
    with pytest.raises(ValueError, match="no model"):
        sm.predict_collective_us("all_to_one", 8, topo)


def _gemm(m, k, n, dtype):
    return CommsOp(compute="gemm", mm_dims=[m, k, k, n], dtype=dtype)


# (op, measured ms, what: measured on one NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6)
MEASURED = [
    (_gemm(1024, 4096, 4096, "bfloat16"), 0.0458,
     "GEMM_A torch.matmul bf16", True),
    (_gemm(1024, 4096, 4096, "bfloat16"), 0.0479, "GEMM_A K3 bf16",
     False),  # 34.7 us: 27.5% under K3's row
    (_gemm(1024, 4096, 1024, "float32"), 0.1784,
     "GEMM_C torch.matmul f32", False),  # 128 us: 28% under
    (CommsOp(compute="emb_lookup", emb_dim=128, num_embs=1_000_000,
             batch_size=8192, bag_size=30, dtype="float32"), 0.0463,
     "K1 headline", True),
]


@pytest.mark.parametrize("op,ms,what,within", MEASURED,
                         ids=[m[2] for m in MEASURED])
def test_compute_roofline_against_measured_rows(op, ms, what, within):
    pred = sm.predict_compute_us(op, H100) / 1e3
    assert pred <= ms  # a roofline never beats the card
    if within:
        assert abs(pred - ms) <= 0.25 * ms, (what, pred)
    else:  # the plain roofline misses this row by more than 25%
        assert abs(pred - ms) > 0.25 * ms, (what, pred)


def test_compute_roofline_formulas():
    assert sm.predict_compute_us(_gemm(1024, 4096, 4096, "bfloat16"),
                                 H100) == pytest.approx(
        2 * 1024 * 4096 * 4096 / 989e12 * 1e6)
    # K1's trainer row sets the rate: 163840 rows predict its own time
    op = CommsOp(compute="emb_lookup", emb_dim=64, batch_size=16384,
                 bag_size=10, dtype="float32")
    assert sm.predict_compute_us(op, H100) == pytest.approx(17.4)
    assert sm.predict_compute_us(CommsOp(compute="nope"), H100) is None


def _trace():
    return [
        CommsOp(comms="all_reduce", in_msg_size=1 << 20,
                out_msg_size=1 << 20),
        CommsOp(comms="all_to_allv", in_msg_size=1 << 18,
                out_msg_size=1 << 18, dtype="bfloat16"),
        CommsOp(comms="wait"),
        CommsOp(comms="all_reduce", in_msg_size=1 << 10,
                out_msg_size=1 << 10),
        CommsOp(comms="unknown_op"),
        _gemm(512, 512, 512, "bfloat16"),
        CommsOp(compute="mystery"),
    ]


def test_predict_trace_counts():
    p = sm.predict_trace(_trace(), sm.slice_topology("h100", 8))
    assert p.n_ops == 3 and p.skipped == 2 and p.n_compute == 1
    assert p.per_op["all_reduce"].count == 2
    assert p.total_bytes == (1 << 22) + (1 << 19) + (1 << 12)
    assert p.serial_us == pytest.approx(p.total_us + p.compute_us)
    assert p.overlap_us == max(p.total_us, p.compute_us)


def test_predict_worlds_and_report():
    preds = sm.predict_worlds(_trace(), "h100", [8, 16, 64])
    assert [p.topo.n_gpus for p in preds] == [8, 16, 64]
    assert preds[0].total_us < preds[1].total_us < preds[2].total_us
    text = sm.format_report(preds)
    assert len(text.splitlines()) == 4 and "8*8n" in text
    rows = json.loads(json.dumps([p.row() for p in preds]))
    assert rows[1]["nodes"] == "8*2n" and all(
        math.isfinite(r["comm_us"]) for r in rows)
