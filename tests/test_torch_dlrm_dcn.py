"""DLRM-DCNv2 on the port (``models/dlrm.py`` with ``arch_interaction=
"dcn"``, ``num_embeddings_per_feature`` and ``multi_hot_sizes``) against
the plain reference of ``tests/dcn_reference.py``, in float64, on seeded
random weights: five tables of 3 to 64 rows, bags of 1 to 5 ids, dim 8, two
cross layers of rank 4, batch 16.

Tolerances (each leaf's gap is its error's norm over the larger of its
reference norm and the median leaf's):
- loss: relative 2e-6.  The port's f32 reads at most 6.3e-7 here; TF32
  products read 2.7e-6 to 7.5e-4.
- gradients by autograd (the dense step's ``value_and_grad``): 2e-5.  The
  port reads at most 3.8e-7, TF32 products 6.4e-4 to 1.5e-3.
- the first gradient worked out from a sparse step's state, and each
  leaf's change after three sparse steps: 1e-4.  The port reads at most
  9.4e-6 and 1.2e-5 (the f32 difference of two states of ~1 carries
  rounding of ~1e-5 of the change); TF32 products 6.4e-4 and 7.8e-4 or
  more.
``test_tf32_products_fail_the_tolerances`` holds the reference in TF32 to
them.  The CUDA test runs the step at the published widths on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import dcn_reference as ref
from param_tpu_torch.backend.base import CommGroup
from param_tpu_torch.kernels import launch_counts
from param_tpu_torch.kernels.dedup import dedup_sum_plain
from param_tpu_torch.kernels.emb_gather import emb_gather_plain
from param_tpu_torch.models.dlrm import (
    DlrmConfig, DlrmModel, low_rank_cross,
)
from param_tpu_torch.ops.embedding import embedding_bag
from param_tpu_torch.ops.mlp import tree_leaves
from param_tpu_torch.utils import profiler

ROWS = [3, 17, 40, 9, 64]
SIZES = [1, 3, 2, 5, 4]
B = 16
SMALL = dict(emb_dim=8, dense_dim=4, bot_mlp=[16, 8], top_mlp=[16, 1],
             batch=B, arch_interaction="dcn", num_embeddings_per_feature=ROWS,
             multi_hot_sizes=SIZES, dcn_num_layers=2, dcn_low_rank_dim=4)
STARTS = list(np.cumsum([0] + ROWS[:-1]))
LOSS_RTOL, GRAD_TOL, STEP_TOL = 2e-6, 2e-5, 1e-4


def _batches(n, seed=0, rows=ROWS, sizes=SIZES, batch=B, dense_dim=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = np.concatenate([rng.integers(0, r, (batch, s))
                              for r, s in zip(rows, sizes)], 1)
        out.append((rng.standard_normal((batch, dense_dim)).astype(
            np.float32), ids.astype(np.int32),
            rng.integers(0, 2, batch).astype(np.float32)))
    return out


def _split(params):
    """The port's leaves in the reference's order, in float64: each table
    cut from the flat tables, then the dense layers."""
    t = params["tables"].detach().double()
    return ([t[s:s + n].clone() for s, n in zip(STARTS, ROWS)]
            + [x.detach().double().clone()
               for x in tree_leaves({k: params[k]
                                     for k in ("bot", "top", "cross")})])


def _reference(params):
    xs = _split(params)
    out, i = {"tables": xs[:len(ROWS)]}, len(ROWS)
    for k in ("bot", "top", "cross"):
        out[k] = []
        for layer in params[k]:
            out[k].append(tuple(xs[i:i + len(layer)]))
            i += len(layer)
    return out


def _f64(batch):
    d, i, l = batch
    return (torch.from_numpy(d).double(), torch.from_numpy(i),
            torch.from_numpy(l).double())


def _gap(got, want):
    """The worst leaf's gap (module notes)."""
    norms = [float(w.norm()) for w in want]
    med = float(np.median(norms))
    return max(float((g.double() - w).norm()) / max(n, med)
               for g, w, n in zip(got, want, norms))


def _model(seed=0, **kw):
    model = DlrmModel(DlrmConfig(**dict(SMALL, **kw)), device="cpu")
    return model, model.init_params(seed)


# ------------------------------------------------------- the whole model
@pytest.mark.parametrize("seed", [0, 1])
def test_value_and_grad_matches_the_reference(seed):
    model, params = _model(seed)
    batch = _batches(1, seed)[0]
    want_loss, want = ref.value_and_grad(_reference(params), *_f64(batch),
                                         SIZES)
    loss, grads = model.make_value_and_grad()(params,
                                              *model.place_batch(batch))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * float(want_loss)
    assert _gap(_split(grads), want) <= GRAD_TOL


def _sparse_steps(model, params, batches, opt, lr, eps, acc0):
    """Three sparse steps: (losses, the first gradient worked out from the
    state after one step, each leaf's change after three)."""
    p0 = _split(params)
    if opt == "sgd":
        step = model.make_sparse_sgd_step(lr)
    else:
        acc = model.init_adagrad_state(params, acc0)
        step = model.make_sparse_adagrad_step(lr, eps=eps,
                                              initial_accumulator=acc0)
    losses = []
    for k, b in enumerate(batches):
        if opt == "sgd":
            _, loss = step(params, *model.place_batch(b))
        else:
            _, _, loss = step(params, acc, *model.place_batch(b))
        losses.append(float(loss))
        if k == 0:
            p1 = _split(params)
            first = [(a - c) / lr for a, c in zip(p0, p1)]
            if opt == "adagrad":
                first = [g * torch.sqrt(a + eps)
                         for g, a in zip(first, _split(acc))]
    return losses, first, [a - c for a, c in zip(_split(params), p0)]


STEP_CASES = [("sgd", 0.1, 1e-7, 0.1), ("adagrad", 0.05, 1e-7, 0.1),
              ("adagrad", 0.05, 1e-8, 0.0)]  # the last: the cell's eps, 0


@pytest.mark.parametrize("opt,lr,eps,acc0", STEP_CASES)
def test_three_sparse_steps_match_the_reference(opt, lr, eps, acc0):
    model, params = _model(3)
    batches = _batches(3, 3)
    r = _reference(params)
    p0 = ref.leaves(r)
    p0 = [x.clone() for x in p0]
    want_losses, want_first = ref.train(r, [_f64(b) for b in batches],
                                        SIZES, opt, lr, eps, acc0)
    losses, first, change = _sparse_steps(model, params, batches, opt, lr,
                                          eps, acc0)
    for got, want in zip(losses, want_losses):
        assert abs(got - want) <= LOSS_RTOL * want
    assert _gap(first, want_first) <= STEP_TOL
    assert _gap(change, [a - c for a, c in zip(ref.leaves(r), p0)]) \
        <= STEP_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_products_fail_the_tolerances(seed):
    """The tolerances are tight enough that TF32 products fail them: the
    reference with every product's operands rounded to TF32, against
    itself in float64."""
    _, params = _model(seed)
    batches = [_f64(b) for b in _batches(3, seed)]
    _, want = ref.value_and_grad(_reference(params), *batches[0], SIZES)
    _, got = ref.value_and_grad(_reference(params), *batches[0], SIZES,
                                tf32=True)
    assert _gap(got, want) > 10 * GRAD_TOL
    r, rt = _reference(params), _reference(params)
    p0 = [x.clone() for x in ref.leaves(r)]
    ref.train(r, batches, SIZES, "sgd", 0.1)
    ref.train(rt, batches, SIZES, "sgd", 0.1, tf32=True)
    assert _gap([a - c for a, c in zip(ref.leaves(rt), p0)],
                [a - c for a, c in zip(ref.leaves(r), p0)]) > 3 * STEP_TOL


# ---------------------------------------------------------- the cross net
def test_low_rank_cross_matches_the_equations():
    """One layer against ``x0 * (W (V x) + b) + x`` written row by row, and
    its hand-written backward against finite differences (float64)."""
    g = torch.Generator().manual_seed(0)
    x0, x = (torch.randn((3, 6), generator=g, dtype=torch.float64)
             for _ in range(2))
    v = torch.randn((6, 2), generator=g, dtype=torch.float64)
    w = torch.randn((2, 6), generator=g, dtype=torch.float64)
    b = torch.randn((6,), generator=g, dtype=torch.float64)
    got = low_rank_cross(x0, x, (v, w, b))
    for i in range(3):
        u = [sum(x[i, f] * v[f, k] for f in range(6)) for k in range(2)]
        for f in range(6):
            h = sum(u[k] * w[k, f] for k in range(2)) + b[f]
            assert abs(float(got[i, f] - (x0[i, f] * h + x[i, f]))) < 1e-12
    inputs = [t.clone().requires_grad_(True) for t in (x0, x, v, w, b)]
    assert torch.autograd.gradcheck(
        lambda a, c, vv, ww, bb: low_rank_cross(a, c, (vv, ww, bb)), inputs)
    # the first layer takes x0 as both inputs
    x0r = x0.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a: low_rank_cross(a, a, (v, w, b)), [x0r])


def test_dcn_interaction_width_and_leaves():
    cfg = DlrmConfig(**SMALL)
    assert cfg.interaction_dim == (5 + 1) * 8
    assert cfg.top_mlp_dims()[0] == 48
    _, params = _model()
    assert params["tables"].shape == (sum(ROWS), 8)
    assert [tuple(t.shape) for t in params["cross"][0]] == [(48, 4), (4, 48),
                                                            (48,)]
    assert not params["cross"][0][2].any()


def test_flat_tables_are_drawn_per_table():
    cfg = dict(SMALL, num_embeddings_per_feature=[3, 20000, 50], emb_dim=8,
               multi_hot_sizes=[1, 2, 3])
    _, params = _model(**cfg)
    big = params["tables"][3:20003].detach()
    assert abs(float(big.std()) - 20000 ** -0.5) < 0.05 * 20000 ** -0.5
    assert torch.equal(_model(**cfg)[1]["tables"], params["tables"])


# ---------------------------------------------------------- the lookup
def test_the_lookup_reads_only_the_real_ids():
    """One step: one ``param_tpu_torch::emb_gather`` call over the (B, L)
    real ids (L = 15, no pad slot), and the counters say B * L ids in B * T
    bags."""
    model, params = _model()
    acc = model.init_adagrad_state(params)
    step = model.make_sparse_adagrad_step(0.05)
    batch = model.place_batch(_batches(1)[0])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        profiler.reset()
        step(params, acc, *batch)
        counters = profiler.counter_totals()
        spans = profiler.span_totals()
    assert counters["dlrm.lookups"] == B * sum(SIZES)
    assert counters["dlrm.bags"] == B * len(SIZES)
    calls = [e for e in prof.events()
             if e.name == "param_tpu_torch::emb_gather"]
    assert len(calls) == 1
    assert list(calls[0].input_shapes[1]) == [B, sum(SIZES)]
    assert spans["dlrm.cross"]["count"] == 2 * 2  # two layers, fwd and bwd
    assert spans["dlrm.cross"]["parents"] == ["dlrm.interaction"]
    assert spans["dlrm.interaction"]["count"] == 2
    assert spans["dlrm.interaction"]["parents"] == ["dlrm.dense_bwd",
                                                    "dlrm.dense_fwd"]


def _loop_bags(table, ids, sizes, weights=None):
    out = torch.zeros((ids.shape[0] * len(sizes), table.shape[1]),
                      dtype=torch.float64)
    for b in range(ids.shape[0]):
        at = 0
        for t, n in enumerate(sizes):
            for j in range(at, at + n):
                w = 1.0 if weights is None else float(weights[b, j])
                out[b * len(sizes) + t] += w * table[ids[b, j]].double()
            at += n
    return out


def test_per_feature_bags_plain_and_backward_match_a_loop():
    """K1's plain version and the embedding bag's backward over per-feature
    bags (an empty one among them) against a loop."""
    sizes = [2, 0, 3, 1]
    g = torch.Generator().manual_seed(1)
    table = torch.randn((30, 5), generator=g)
    ids = torch.randint(0, 30, (4, 6), generator=g, dtype=torch.int32)
    w = torch.rand((4, 6), generator=g)
    for weights in (None, w):
        got = emb_gather_plain(table, ids, weights, sizes)
        torch.testing.assert_close(got.double(),
                                   _loop_bags(table, ids, sizes, weights),
                                   rtol=1e-5, atol=1e-6)
    t = table.clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    gout = torch.randn((16, 5), generator=g)
    (embedding_bag(t, ids, wt, sizes) * gout).sum().backward()
    t2 = table.double().requires_grad_(True)
    w2 = w.double().requires_grad_(True)
    rows, at = [], 0
    for b in range(4):
        at = 0
        for n in sizes:
            rows.append(sum((w2[b, j] * t2[ids[b, j]]
                             for j in range(at, at + n)),
                            torch.zeros(5, dtype=torch.float64)))
            at += n
    (torch.stack(rows) * gout.double()).sum().backward()
    # f32 sums against float64 ones
    torch.testing.assert_close(t.grad.double(), t2.grad, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(wt.grad.double(), w2.grad, rtol=1e-5,
                               atol=1e-6)


def test_per_feature_dedup_plain_is_the_expansion():
    """The dedup over per-feature bags gives what one gradient row a lookup
    (its bag's) gives."""
    sizes = [2, 0, 3, 1]
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 9, (5, 6), generator=g, dtype=torch.int32)
    grad = torch.randn((20, 4), generator=g)
    rows, tot = dedup_sum_plain(ids, grad, -0.5, 9, sizes)
    feats = [t for t, n in enumerate(sizes) for _ in range(n)]
    expanded = torch.stack([grad[b * 4 + feats[j]] for b in range(5)
                            for j in range(6)])
    want = torch.zeros((9, 4))
    want.index_add_(0, ids.reshape(-1).long(), -0.5 * expanded)
    u = torch.unique(ids)
    assert torch.equal(rows[:len(u)], u) and (rows[len(u):] == 9).all()
    torch.testing.assert_close(tot[:len(u)], want[u.long()])
    assert not tot[len(u):].any()
    with pytest.raises(ValueError):
        dedup_sum_plain(ids, grad, -0.5, 9, [2, 0, 3, 2])


# ------------------------------------------------------------ the layouts
def test_equal_lists_keep_the_fixed_layout():
    cfg = DlrmConfig(emb_dim=8, bot_mlp=[16, 8], top_mlp=[16, 1],
                     num_embeddings_per_feature=[50] * 3,
                     multi_hot_sizes=[4] * 3)
    assert cfg.num_tables == 3 and cfg.rows_per_table == 50 and cfg.nnz == 4
    assert cfg.equal_tables and cfg.fixed_nnz
    params = DlrmModel(cfg, device="cpu").init_params(0)
    assert params["tables"].shape == (3, 50, 8) and "cross" not in params


def test_unequal_tables_with_fixed_bags():
    """Tables of their own rows under (B, T, nnz) ids, read as the
    per-feature layout with every size nnz: the step matches the same
    model's dense step, table for table."""
    kw = dict(SMALL, multi_hot_sizes=[3] * 5)
    model, params = _model(4, **kw)
    rng = np.random.default_rng(4)
    ids = np.stack([rng.integers(0, r, (B, 3)) for r in ROWS], 1)
    batch = model.place_batch((rng.standard_normal((B, 4)).astype(np.float32),
                               ids, rng.integers(0, 2, B).astype(np.float32)))
    _, grads = model.make_value_and_grad()(params, *batch)
    p0 = params["tables"].detach().clone()
    model.make_sparse_sgd_step(0.1)(params, *batch)
    torch.testing.assert_close(params["tables"].detach(),
                               p0 - 0.1 * grads["tables"], rtol=1e-6,
                               atol=1e-7)


def test_a_sharded_model_needs_equal_tables_and_bags():
    group = CommGroup(ranks=[0, 1])
    with pytest.raises(ValueError, match="ROADMAP C4"):
        DlrmModel(DlrmConfig(**dict(SMALL, num_embeddings_per_feature=[
            3, 17, 40, 9], multi_hot_sizes=[2] * 4)), group=group,
            device="cpu")
    with pytest.raises(ValueError, match="ROADMAP C2"):
        DlrmModel(DlrmConfig(**dict(SMALL, num_embeddings_per_feature=[
            64] * 4, multi_hot_sizes=[1, 2, 3, 4])), group=group,
            device="cpu")


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_dcn_step_on_the_card_at_the_published_widths():
    """The sparse Adagrad step at DLRM-DCNv2's widths (26 features of the
    published bag sizes, dim 128, 3 cross layers of rank 512, batch 8192;
    tables capped at 100k rows): one K1 launch a step, the dedup and K2
    once; the ``dlrm.step`` children's CUDA-event time covers >= 97% of it;
    the step's loss within 1e-5 of the CPU's on the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1]
    rows = [min(r, 100_000) for r in (
        40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
        3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
        40000000, 40000000, 590152, 12973, 108, 36)]
    cfg = DlrmConfig(emb_dim=128, dense_dim=13, bot_mlp=[512, 256, 128],
                     top_mlp=[1024, 1024, 512, 256, 1], batch=8192,
                     arch_interaction="dcn", num_embeddings_per_feature=rows,
                     multi_hot_sizes=sizes, dcn_num_layers=3,
                     dcn_low_rank_dim=512)
    model = DlrmModel(cfg, device="cuda")
    params = model.init_params(0)
    acc = model.init_adagrad_state(params, 0.0)
    step = model.make_sparse_adagrad_step(0.004, eps=1e-8,
                                          initial_accumulator=0.0)
    batches = [model.place_batch(b) for b in _batches(
        2, 0, rows, sizes, 8192, 13)]
    for i in range(3):
        step(params, acc, *batches[i % 2])
    n = 6
    before = dict(launch_counts)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        profiler.reset()
        for i in range(n):
            step(params, acc, *batches[i % 2])
        torch.cuda.synchronize()
    s = profiler.span_totals()
    whole = s["dlrm.step"]
    seen = {k: (v["count"], round(v["device_ms"], 3)) for k, v in s.items()}
    assert whole["count"] == n
    covered = 1.0 - whole["self_device_ms"] / whole["device_ms"]
    print(f"dlrm.step's children cover {covered:.4%} of its "
          f"{whole['device_ms'] / n:.3f} ms a step")
    assert covered >= 0.97, seen
    assert s["dlrm.cross"]["count"] == 2 * 3 * n, seen
    for k in ("emb_gather", "dedup_sum", "sparse_update_adagrad"):
        assert launch_counts[k] - before[k] == n, k
    cpu = DlrmModel(cfg, device="cpu")
    p_cpu = {k: (v.detach().cpu() if torch.is_tensor(v) else
                 [tuple(x.detach().cpu() for x in layer) for layer in v])
             for k, v in params.items()}
    b_cpu = tuple(x.cpu() for x in batches[0])
    with torch.no_grad():
        want = cpu.loss_fn(p_cpu, *b_cpu)
        got = model.loss_fn(params, *batches[0])
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
