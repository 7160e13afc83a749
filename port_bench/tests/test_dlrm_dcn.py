"""CPU tests of the DLRM-DCNv2 family (``models/dlrm_dcn.py``,
``reference_dcn.py``, ``data_dcn.py``, ``metrics/cross_roofline.py``): its
program at a tiny size against its plain reference, the control and the
fault against the cell's limits, and the FLOP counts by hand.

    python -m pytest port_bench/tests/test_dlrm_dcn.py -q
"""

from __future__ import annotations

import os

import pytest
import torch

from port_bench import check, data_dcn, reference_dcn, run, spec, worker

SEED = 2**33 + 7
CELL = "dcnv2.adagrad.multihot"


def tiny_cell(optimizer="sparse_adagrad", batch=16):
    """A cut-down dlrm-dcnv2-mlperf (tables of 3 to 64 rows, bags of 1 to 5
    ids, dim 8, 2 cross layers of rank 4) with the real cell's limits."""
    cfg = dict(spec.load_json(os.path.join(spec.HERE, "configs",
                                           "dlrm-dcnv2-mlperf.json")))
    cfg.update(rows=[3, 17, 40, 9, 64], multi_hot_sizes=[1, 3, 2, 5, 4],
               emb_dim=8, dense_dim=4, bot_mlp=[16, 8], top_mlp=[16, 1],
               dcn_num_layers=2, dcn_low_rank_dim=4, optimizer=optimizer,
               lr=0.05)
    traffic = {"batch": batch, "ids": "uniform", "ring": 4}
    return spec.Cell("tiny_dcn", cfg, traffic, 1, spec.cell(CELL).limits)


def test_the_cell_is_found_and_refuses_what_it_would_not_run():
    cell = spec.cell(CELL)
    family = spec.model(cell.config["model"])
    assert family.NAME == "dlrm_dcn" and cell.chips == 1
    cfg = cell.config
    assert len(cfg["rows"]) == len(cfg["multi_hot_sizes"]) == 26
    assert sum(cfg["multi_hot_sizes"]) == 214
    assert sum(cfg["rows"]) == 54_184_588
    for change in ({"tf32": True}, {"interaction": "dot"},
                   {"dtype": "bfloat16"}, {"model": "dlrm"}):
        with pytest.raises(ValueError):
            family.dlrm_config(dict(cfg, **change), cell.traffic)


@pytest.mark.parametrize("optimizer", ["sparse_adagrad", "sparse_sgd"])
def test_program_checked_steps_agree_with_the_reference(optimizer):
    cell = tiny_cell(optimizer)
    out = run.run_cell(cell, SEED, 0.05, False, device_type="cpu")
    values = out["values"]
    assert check.verdict(values, cell.limits), values
    for k, v in values.items():
        assert v < 1e-5, (k, v)
    assert out["ranks"][0]["n_steps"] >= worker.IN_FLIGHT + 16


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_and_half_batch_are_not_correct(seed):
    """At batch 512: below it, the tiny model's few products leave TF32's
    gradient gap under the cell's limit on some seeds."""
    cell = tiny_cell(batch=512)
    ref = reference_dcn.readings(cell.config, cell.traffic, seed, 1, "cpu")
    family = spec.model("dlrm_dcn")
    for name, kw in family.controls(1).items():
        got = reference_dcn.readings(cell.config, cell.traffic, seed, 1,
                                     "cpu", **kw)
        values = check.gaps(got, ref)
        assert not check.verdict(values, cell.limits), (name, values)


def test_batches_hold_each_feature_within_its_table():
    cell = tiny_cell()
    cfg = cell.config
    dense, ids, labels = data_dcn.shard_batch(cfg, cell.traffic, SEED, 0, 0,
                                              1, "cpu")
    assert ids.shape == (16, 15) and ids.dtype == torch.int32
    at = 0
    for rows, size in zip(cfg["rows"], cfg["multi_hot_sizes"]):
        part = ids[:, at:at + size]
        assert 0 <= int(part.min()) and int(part.max()) < rows
        at += size
    again = data_dcn.shard_batch(cfg, cell.traffic, SEED, 0, 0, 1, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((dense, ids, labels), again))


def test_flop_counts_by_hand():
    family = spec.model("dlrm_dcn")
    cfg = tiny_cell().config
    # F = (5 + 1) * 8 = 48, r = 4: a layer is 6 GEMMs of 2 * B * 48 * 4
    assert family.cross_flops(cfg, 10) == 2 * 6 * 2 * 10 * 48 * 4
    # bottom 4-16-8: the first layer 2 passes of 2*10*4*16, the second 3 of
    # 2*10*16*8; top 48-16-1: 3 passes of 2*10*(48*16 + 16*1)
    bot = 2 * 2 * 10 * 4 * 16 + 3 * 2 * 10 * 16 * 8
    top = 3 * 2 * 10 * (48 * 16 + 16)
    assert family.step_flops(cfg, 10) == bot + top + 46080
    # the published cell: 3 layers of 6 x 2 x 8192 x 3456 x 512
    full = spec.cell(CELL).config
    assert family.cross_flops(full, 8192) == 521_838_526_464
    assert abs(family.step_flops(full, 8192) / 787.9e9 - 1) < 1e-3


def test_byte_counts_by_hand():
    """The lookup's and the row update's bytes of two traced steps: the
    distinct rows of each ring batch, its B x L ids, B x T pooled rows."""
    cell = tiny_cell()
    cfg = cell.config
    prog = spec.model("dlrm_dcn").Program(cell, SEED, 0, 1, None,
                                          torch.device("cpu"))
    got = prog.trace_counts([1, 1])
    ids = data_dcn.shard_ids(cfg, cell.traffic, SEED, 1, 0, 1, "cpu")
    at, rows = 0, set()
    for start, size in zip(data_dcn.row_starts(cfg), cfg["multi_hot_sizes"]):
        rows.update((ids[:, at:at + size].reshape(-1) + start).tolist())
        at += size
    u, B, D = len(rows), 16, 8
    assert got["lookup_bytes"] == 2 * (u * D * 4 + B * 15 * 4 + B * 5 * D * 4)
    # Adagrad: each row and its accumulator read and written, its summed
    # gradient row and its id read
    assert got["update_bytes"] == 2 * u * (D * 4 * 5 + 4)


def test_cross_roofline_reads_the_spans(monkeypatch):
    from param_tpu_torch.utils import profiler

    mod = spec._module("metrics", "cross_roofline")
    run_ = {"ranks": [{"cross_flops": 67e9}]}
    monkeypatch.setattr(profiler, "span_trees", lambda root: [])
    assert mod.read(run_) is None
    trees = [{"dlrm.step": 30.0, "dlrm.cross": ms} for ms in (2.0, 1.0, 9.0)]
    monkeypatch.setattr(profiler, "span_trees", lambda root: trees)
    # 67 GFLOP at 67 TF/s is 1 ms; the median step's cross spans take 2 ms
    assert mod.read(run_) == pytest.approx(50.0)
    assert mod.read({"ranks": [{}]}) is None
