"""The port's attention-window detection (``param_tpu_torch.trace.
attention_fusion``) against the JAX package's, on the CPU.

The three PyTorch execution traces of ``tests/fixtures`` (recorded by
``scripts/gen_transformer_et.py`` with torch's ``ExecutionTraceObserver``,
a pre-LN block at llama2-7B attention width, or at (1, 2, 256, 128)) give
the same selected nodes and the same forward and backward windows in both
packages, field by field: anchor, skipped ids, q / k / v / dO slots with
their transposed flag, the replaced outputs and their kinds, shape, scale,
causal and mask_assumed.  Detection only: nothing is replayed at S 2048 on
the CPU.  The JAX package's own fusion tests skip without the reference
checkout; these hold the fixture checks in their place.
"""

import dataclasses
import gzip
import json
import os

import pytest

from param_tpu.trace.attention_fusion import (
    find_attention_bwd_windows as ref_bwd, find_attention_windows as ref_fwd,
)
from param_tpu.trace.pytorch_op_replay import PyTorchOpReplay as RefReplay
from param_tpu_torch.trace.attention_fusion import (
    find_attention_bwd_windows, find_attention_windows,
)
from param_tpu_torch.trace.pytorch_op_replay import PyTorchOpReplay

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# fixture -> (selected ops, forward windows, backward windows, shape)
CASES = {
    "transformer_long_et": (112, 4, 0, (1, 32, 2048, 128)),
    "transformer_train_long_et": (450, 4, 4, (1, 32, 2048, 128)),
    "transformer_train_et": (226, 2, 2, (1, 2, 256, 128)),
}


def _load(name):
    with gzip.open(os.path.join(FIXTURES, f"{name}.json.gz"), "rt") as f:
        return json.load(f)


@pytest.fixture(scope="module", params=sorted(CASES))
def fixture(request):
    data = _load(request.param)
    return (request.param, RefReplay(data).nodes,
            PyTorchOpReplay(data, device="cpu").nodes)


def test_node_selection_matches(fixture):
    name, ref_nodes, nodes = fixture
    assert [n.id for n in nodes] == [n.id for n in ref_nodes]
    assert [n.name for n in nodes] == [n.name for n in ref_nodes]
    assert len(nodes) == CASES[name][0]


def test_forward_windows_match(fixture):
    name, ref_nodes, nodes = fixture
    want = [dataclasses.asdict(w) for w in ref_fwd(ref_nodes)]
    got = [dataclasses.asdict(w) for w in find_attention_windows(nodes)]
    assert got == want
    assert len(got) == CASES[name][1]
    for w in got:
        assert w["shape"] == CASES[name][3]
        assert w["causal"] and w["mask_assumed"]
        assert w["scale"] == pytest.approx(1 / 128 ** 0.5)


def test_backward_windows_match(fixture):
    name, ref_nodes, nodes = fixture
    want = [dataclasses.asdict(w) for w in ref_bwd(ref_nodes)]
    got = [dataclasses.asdict(w) for w in find_attention_bwd_windows(nodes)]
    assert got == want
    assert len(got) == CASES[name][2]
    b, h, s, d = CASES[name][3]
    for w in got:
        assert w["shape"] == (b, h, s, s, d)
        assert not w["q"][3] and w["k"][3] and not w["v"][3]  # cached K^T
        assert {o[3] for o in w["outs"]} == {"dq", "dkT", "dv"}


def test_fwd_and_bwd_windows_are_disjoint(fixture):
    _, _, nodes = fixture
    ids = [i for w in (*find_attention_windows(nodes),
                       *find_attention_bwd_windows(nodes))
           for i in w.skip_ids]
    assert len(ids) == len(set(ids))


@pytest.mark.parametrize("fuse", ["attention", "attention-train"])
def test_replay_takes_the_windows(fuse):
    """The replayer's fused windows are the detector's; ``attention``
    leaves the backward windows alone."""
    data = _load("transformer_train_et")
    r = PyTorchOpReplay(data, fuse=fuse, device="cpu")
    ref = RefReplay(data, fuse=fuse)
    assert [w.anchor_id for w in r.fused_windows] == \
        [w.anchor_id for w in ref.fused_windows]
    assert [w.anchor_id for w in r.fused_bwd_windows] == \
        [w.anchor_id for w in ref.fused_bwd_windows]
    assert len(r.fused_bwd_windows) == (2 if fuse == "attention-train" else 0)
    assert r._fused_skip == ref._fused_skip


def test_no_windows_without_attention():
    """A trace with no softmax has no window."""
    data = _load("linear_et")
    nodes = PyTorchOpReplay(data, device="cpu").nodes
    assert find_attention_windows(nodes) == []
    assert find_attention_bwd_windows(nodes) == []
