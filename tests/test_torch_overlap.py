"""The port's overlap benches against the reference: ``OverlapResult``'s
arithmetic exactly, then each chain's checksum (same-group: every
collective alone and all of them together; split-pgs; comms-compute with
``gemm`` and ``emb_lookup``: the collective alone, the compute alone and
both) after the same number of steps, in spawned gloo worlds of 2 and 4
(tests/torch_remainder_worker.py, no JAX in the children), against the
reference's chain of the same steps on a CPU mesh of the same size, within
rtol 1e-5 (f32 sums in another order).  The reference's chains are taken
from its own ``run_same_group`` / ``run_split_pgs`` / ``run`` with its
chain timer replaced by one that evaluates the chain once at that length.

No assertion is made on a time or an efficiency value: the timed runs are
only run.
"""

import jax
import pytest
import torch

from param_tpu.comms import overlap_bench as ref_ob
from param_tpu_torch.backend import CommGroup
from param_tpu_torch.cli import comms_compute as cc_cli
from param_tpu_torch.cli import overlap as ov_cli
from param_tpu_torch.comms.overlap_bench import OverlapResult, _coll_step

import torch_remainder_worker as worker

WORLDS = (2, 4)


@pytest.mark.parametrize("solo,both", [
    ((100, 100), 100), ((100, 100), 200), ((100, 50), 120),
    ((100, 100, 100), 150), ((80, 30, 10), 95), ((5, 5), 4),
    ((10,), 10), ((0, 0), 0), ((100, 50), 300), ((7.5, 2.25), 8.125)])
def test_overlap_result_matches_reference(solo, both):
    got, want = OverlapResult(solo, both), ref_ob.OverlapResult(solo, both)
    assert got.overlap_efficiency == want.overlap_efficiency
    assert got.t_a_us == want.t_a_us and got.t_both_us == want.t_both_us
    if len(solo) > 1:
        assert got.t_b_us == want.t_b_us


def test_coll_step_rejects_unknown():
    with pytest.raises(ValueError, match="unsupported overlap collective"):
        _coll_step("bogus", CommGroup(ranks=[0]), 1.0)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return worker.run_worlds("overlap", WORLDS, tmp_path_factory)


def _reference_chains(monkeypatch, run):
    """The values of the reference's chains at CHAIN_STEPS steps, in the
    order its bench times them."""
    seen = []

    def chain_value(fn, n_lo=None, n_hi=None, **_):
        seen.append(float(fn(worker.CHAIN_STEPS)))
        return 1.0

    monkeypatch.setattr(ref_ob, "measure_chain", chain_value)
    run()
    return seen


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-5), (got, want)


@pytest.mark.parametrize("n", WORLDS)
def test_same_group_chains_match_reference(worlds, n, monkeypatch):
    bench = ref_ob.OverlapBench(devices=jax.devices()[:n])
    want = _reference_chains(monkeypatch, lambda: bench.run_same_group(
        *worker.OVERLAP_SET, worker.OVERLAP_SIZE))
    assert len(want) == 1 + len(worker.OVERLAP_SET[1]) + 1
    for r in range(n):
        got = worlds[n][r]["same_group"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        assert worlds[n][r]["same_group_timed"][0] == 2


@pytest.mark.parametrize("n", WORLDS)
def test_split_pgs_chains_match_reference(worlds, n, monkeypatch):
    bench = ref_ob.OverlapBench(devices=jax.devices()[:n])
    if n < 4:
        with pytest.raises(ValueError) as e:
            bench.run_split_pgs("all_reduce", worker.OVERLAP_SIZE)
        for r in range(n):
            assert worlds[n][r]["split_pgs_error"] == str(e.value)
        return
    single, both = _reference_chains(monkeypatch, lambda: bench.run_split_pgs(
        "all_reduce", worker.OVERLAP_SIZE))
    for r in range(n):
        got_single, got_both = worlds[n][r]["split_pgs"]
        _close(got_both, both)
        if r < n // 2:
            _close(got_single, single)
        else:
            assert got_single is None
        assert worlds[n][r]["split_pgs_timed"] == 2


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kernel", sorted(worker.COMPUTE_KW))
def test_comms_compute_chains_match_reference(worlds, n, kernel,
                                              monkeypatch):
    bench = ref_ob.CommsComputeBench(devices=jax.devices()[:n])
    want = _reference_chains(monkeypatch, lambda: bench.run(
        "all_reduce", worker.OVERLAP_SIZE, kernel,
        **worker.COMPUTE_KW[kernel]))
    for r in range(n):
        got = worlds[n][r][kernel]
        for key, w in zip(("comm", "compute", "both"), want):
            _close(got[key], w)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kernel", ["d2h", "h2d"])
def test_host_transfer_runs(worlds, n, kernel):
    keys = worlds[n][0][f"run:{kernel}"]
    assert "host_link_gbs" in keys and "t_both_us" in keys


def test_overlap_cli_world_1(capsys):
    assert ov_cli.main(["--device", "cpu", "--b", "4K", "--e", "16K",
                        "--collective-pair", "all_gather,all_to_all",
                        "--chain", "2", "--log", "WARNING"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("OVERLAP-RES mode=same-group "
                              "all_reduce+all_gather+all_to_all")]
    assert [ln.split()[3] for ln in lines] == ["size=4096B", "size=16384B"]


def test_overlap_cli_split_pgs_needs_4():
    with pytest.raises(ValueError, match="even device count >= 4"):
        ov_cli.main(["--device", "cpu", "--overlap-pair-pgs", "--b", "4K",
                     "--e", "4K", "--log", "WARNING"])


@pytest.mark.parametrize("kernel", ["gemm", "emb_lookup", "d2h", "h2d"])
def test_comms_compute_cli_world_1(capsys, kernel):
    assert cc_cli.main(["--device", "cpu", "--kernel", kernel, "--mm-dim",
                        "32", "--emb-rows", "500", "--emb-batch", "16",
                        "--emb-nnz", "3", "--b", "4K", "--chain", "2",
                        "--log", "WARNING"]) == 0
    out = capsys.readouterr().out
    assert f"COMMS-COMPUTE-RES all_reduce+{kernel} size=4096B" in out


@pytest.mark.parametrize("mod", [ov_cli, cc_cli])
def test_new_clis_default_to_cuda(mod):
    assert mod.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--log", "WARNING"])
