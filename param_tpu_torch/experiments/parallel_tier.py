"""The multi-device transformer tier against its single-device oracles:
sequence-parallel ring attention, the Megatron dp x tp step, the GPipe step,
the expert-parallel MoE layer and the dp x tp MLP step.

Each ``check_*`` draws its inputs from a seed on the host (so every rank
holds the same numbers), runs the parallel path on this rank's shard with
the launch counts reset just before and read just after, runs the
single-device oracle on the same inputs on this rank's device, and holds
this rank's part of the result to the oracle's.  It returns the wall time
of the parallel run, its kernel launches, the largest errors and the steady
ms of a call of each (``ms``, ``oracle_ms``: host clock around a
synchronised call, median of 5 after one untimed call), and raises
``AssertionError`` on a mismatch.  ``chip_smoke.py`` phase 21 calls
them in a world of one at llama2-7B width.

Over every card of a machine, one rank a card on NCCL, in f32 (ring
attention over n cards, tp at (n / 2, 2) and (1, n), pp over n stages, MoE
with n experts, the MLP at (n / 2, 2); loss rtol 1e-4, the largest
parameter error printed); rank 0 prints one JSON line:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m param_tpu_torch.experiments.parallel_tier

``--device cpu --small`` runs the same on gloo at small widths.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch
import torch.distributed as dist

from param_tpu_torch import kernels
from param_tpu_torch.backend import DistBackend
from param_tpu_torch.models import moe, transformer as tfm
from param_tpu_torch.models.parallel import group_rank, mesh_groups
from param_tpu_torch.ops.attention import flash_attention
from param_tpu_torch.ops.mlp import (
    init_mlp, make_tp_mlp_train_step, mlp_forward, mlp_tp_shard,
)
from param_tpu_torch.ops.ring_attention import ring_attention
from param_tpu_torch.utils.dtypes import dtype_from_name


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _run(fn, dev):
    """fn() with the launch counts reset just before and read just after;
    -> (result, wall s, the launches)."""
    _sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    return out, wall, {k: v for k, v in kernels.launch_counts.items() if v}


def _steady_ms(fn, dev, reps=5) -> float:
    """Median host-clock ms of a synchronised call of ``fn``, after one
    untimed call."""
    fn()
    out = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want, strict=True))


def _close(label, got, want, rtol, atol=0.0) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if not torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol):
            raise AssertionError(
                f"{label}: tensor {i} differs from the oracle's by "
                f"{(g.float() - w.float()).abs().max().item():.3e} (rtol "
                f"{rtol}, atol {atol})")


def _loss_close(label, got, want, rtol) -> None:
    if not math.isclose(got, want, rel_tol=rtol):
        raise AssertionError(f"{label}: loss {got} against the oracle's "
                             f"{want} (rtol {rtol})")


def _randn(gen, shape, scale, dtype, dev):
    return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)


def _to(tree, dev):
    return {k: (tuple(t.to(dev) for t in v) if isinstance(v, tuple)
                else v.to(dev)) for k, v in tree.items()}


# ------------------------------------------------------------------ ring
def check_ring(group, shape, dtype, dev, *, causal=True, seed=0, tol=None):
    """``ring_attention`` of (B, H, n * S_local, D) q, k, v against K6's
    ``flash_attention`` over the whole sequence, this rank's rows.
    ``tol(q, k, v, want, causal)`` gives the per-element bound (default:
    rtol 3e-5 and atol 3e-5, the reference's ring tolerance against the
    plain version, plus 2e-5, K6's own in f32)."""
    n, r = group.size, group_rank(group)
    b, h, s, d = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (_randn(gen, (b, h, n * s, d), 0.3, dtype, dev)
               for _ in range(3))
    rows = slice(r * s, (r + 1) * s)
    shard = [t[:, :, rows].contiguous() for t in (q, k, v)]
    got, wall, launches = _run(
        lambda: ring_attention(*shard, group, causal=causal), dev)
    want = flash_attention(q, k, v, causal=causal)[:, :, rows]
    err = (got.float() - want.float()).abs()
    bound = (5e-5 + 3e-5 * want.float().abs() if tol is None
             else tol(*shard[:1], k, v, want, causal))
    if not (err <= bound).all():
        raise AssertionError(f"ring attention {shape} x {n} {dtype}: max "
                             f"error {err.max().item():.3e} over its bound")
    return dict(wall_s=wall, launches=launches, max_abs_err=err.max().item(),
                ms=_steady_ms(lambda: ring_attention(*shard, group,
                                                     causal=causal), dev),
                oracle_ms=_steady_ms(lambda: flash_attention(
                    q, k, v, causal=causal), dev))


# ------------------------------------------------------ tensor parallel
def check_tp(world, dp, tp, cfg, dev, *, steps=2, lr=1e-4, loss_rtol=1e-4,
             param_rtol=None, seed=0):
    """``make_sharded_train_step`` at (dp, tp) for ``steps`` steps against
    ``make_train_step`` on the whole batch (batch ``cfg.batch``): losses
    within ``loss_rtol``, this rank's shard against the same shard of the
    oracle's parameters (within ``param_rtol`` if given)."""
    groups = mesh_groups(world, dp, tp)
    i, j = groups.dp_index, groups.tp_index
    gen = torch.Generator().manual_seed(seed)
    full = _to(tfm.init_params(gen, cfg, "cpu"), dev)
    x = _randn(gen, (cfg.batch, cfg.seq, cfg.emb), 0.1,
               full["w1"].dtype, dev)
    mb = cfg.batch // dp
    xs = x[i * mb:(i + 1) * mb]
    step = tfm.make_sharded_train_step(groups, cfg, lr)
    state = {"p": tfm.tp_shard(full, cfg, j, tp), "losses": []}

    def train():
        for _ in range(steps):
            state["p"], loss = step(state["p"], xs)
            state["losses"].append(loss.item())

    _, wall, launches = _run(train, dev)
    oracle = tfm.make_train_step(cfg, lr)
    want_losses = []
    for _ in range(steps):
        full, loss = oracle(full, x)
        want_losses.append(loss.item())
    label = f"tp step ({dp}, {tp})"
    for got, want in zip(state["losses"], want_losses):
        _loss_close(label, got, want, loss_rtol)
    got_p = tfm.leaves(state["p"])
    want_p = tfm.leaves(tfm.tp_shard(full, cfg, j, tp))
    if param_rtol is not None:
        _close(label, got_p, want_p, param_rtol)
    return dict(wall_s=wall, launches=launches, losses=state["losses"],
                oracle_losses=want_losses, max_param_err=_err(got_p, want_p),
                ms=_steady_ms(lambda: step(state["p"], xs), dev),
                oracle_ms=_steady_ms(lambda: oracle(full, x), dev))


# ----------------------------------------------------- pipeline parallel
def _sequential_step(blocks, x, cfg, lr):
    """The oracle of the pipeline step: the blocks applied in stage order,
    loss mean(out^2), SGD on every block."""
    ts = [[t.detach().requires_grad_(True) for t in tfm.leaves(p)]
          for p in blocks]
    with torch.enable_grad():
        out = x
        for p, t in zip(blocks, ts):
            out = tfm.block_apply(tfm._rebuild(p, t), out, cfg)
        loss = torch.mean(torch.square(out.float()))
        grads = torch.autograd.grad(loss, [t for ps in ts for t in ps])
    it = iter(grads)
    return [tfm._sgd(p, [next(it) for _ in t], lr)
            for p, t in zip(blocks, ts)], loss.detach()


def check_pp(group, cfg, n_microbatches, dev, *, lr=1e-4, loss_rtol=1e-4,
             seed=0):
    """``make_pipeline_train_step`` over the group's n stages (batch
    ``cfg.batch`` in ``n_microbatches``) for one step against the blocks
    applied in order on one device: the loss within ``loss_rtol``, this
    stage's block against the oracle's."""
    n, r = group.size, group_rank(group)
    gen = torch.Generator().manual_seed(seed)
    stacked = tfm.init_stacked_params(gen, cfg, n, "cpu")
    x = _randn(gen, (cfg.batch, cfg.seq, cfg.emb), 0.1,
               stacked["w1"].dtype, dev)
    block = _to(tfm.stage_params(stacked, r), dev)
    step = tfm.make_pipeline_train_step(group, cfg, n_microbatches, lr)
    (got_p, loss), wall, launches = _run(lambda: step(block, x), dev)
    blocks = [_to(tfm.stage_params(stacked, s), dev) for s in range(n)]
    want, want_loss = _sequential_step(blocks, x, cfg, lr)
    _loss_close(f"pp step ({n} stages)", loss.item(), want_loss.item(),
                loss_rtol)
    return dict(wall_s=wall, launches=launches, loss=loss.item(),
                oracle_loss=want_loss.item(),
                max_param_err=_err(tfm.leaves(got_p), tfm.leaves(want[r])),
                ms=_steady_ms(lambda: step(block, x), dev),
                oracle_ms=_steady_ms(
                    lambda: _sequential_step(blocks, x, cfg, lr), dev))


# ------------------------------------------------------------------- MoE
def _moe_oracle_step(params, x, cfg, n, lr):
    """One SGD step of the single-device oracle with the ep step's
    objective: the sum over the n senders of each one's mean-square loss
    (the ep step's router and expert gradients sum over ranks)."""
    ts = [params[k].detach().requires_grad_(True) for k in moe.KEYS]
    with torch.enable_grad():
        y = x + moe.moe_apply_reference(dict(zip(moe.KEYS, ts)), x, cfg, n)
        per = torch.square(y.float()).reshape(n, -1).mean(dim=1)
        grads = torch.autograd.grad(per.sum(), ts)
    return ({k: (params[k].float() - lr * g.float()).to(params[k].dtype)
             for k, g in zip(moe.KEYS, grads)}, per.mean().detach())


def check_moe(group, cfg, tokens, dev, *, lr=1e-3, out_tol=None,
              loss_rtol=1e-4, seed=0):
    """``moe_apply_ep`` with one expert a rank and ``tokens`` tokens a rank
    against ``moe_apply_reference`` (n senders), this rank's rows, within
    ``out_tol(want)`` (default atol = rtol = 2e-5); then one
    ``make_moe_train_step`` step against the oracle's (loss within
    ``loss_rtol``)."""
    n, r = group.size, group_rank(group)
    gen = torch.Generator().manual_seed(seed)
    dt = dtype_from_name(cfg.dtype)
    full = {k: v.to(dev) for k, v in moe.init_moe_params(
        gen, cfg, "cpu").items()}
    x = _randn(gen, (n * tokens, cfg.emb), 0.5, dt, dev)
    rows = slice(r * tokens, (r + 1) * tokens)
    mine = moe.expert_shard(full, r)
    got, wall, launches = _run(
        lambda: moe.moe_apply_ep(mine, x[rows], group, cfg), dev)
    want = moe.moe_apply_reference(full, x, cfg, n)[rows]
    err = (got.float() - want.float()).abs()
    bound = (2e-5 + 2e-5 * want.float().abs() if out_tol is None
             else out_tol(want))
    if not (err <= bound).all():
        raise AssertionError(f"moe_apply_ep ({n} experts, {tokens} tokens a "
                             f"rank): max error {err.max().item():.3e} over "
                             f"its bound")
    step = moe.make_moe_train_step(group, cfg, lr)
    (new, loss), step_wall, _ = _run(lambda: step(mine, x[rows]), dev)
    want_p, want_loss = _moe_oracle_step(full, x, cfg, n, lr)
    if not math.isfinite(loss.item()):
        raise AssertionError(f"moe train step: loss {loss.item()}")
    _loss_close(f"moe train step ({n} experts)", loss.item(),
                want_loss.item(), loss_rtol)
    mine_want = moe.expert_shard(want_p, r)
    return dict(wall_s=wall, step_wall_s=step_wall, launches=launches,
                max_abs_err=err.max().item(), loss=loss.item(),
                oracle_loss=want_loss.item(),
                max_param_err=_err([new[k] for k in moe.KEYS],
                                   [mine_want[k] for k in moe.KEYS]),
                ms=_steady_ms(lambda: moe.moe_apply_ep(mine, x[rows], group,
                                                       cfg), dev),
                oracle_ms=_steady_ms(lambda: moe.moe_apply_reference(
                    full, x, cfg, n), dev))


# ------------------------------------------------------------------- MLP
def _mlp_step(params, x, y, lr):
    """The plain single-device step: loss mean((logit - y)^2), SGD."""
    ts = [t.detach().requires_grad_(True) for pair in params for t in pair]
    with torch.enable_grad():
        pairs = [tuple(ts[2 * i:2 * i + 2]) for i in range(len(params))]
        loss = torch.mean(torch.square(mlp_forward(pairs, x)[:, 0] - y))
        grads = torch.autograd.grad(loss, ts)
    new = [t.detach() - lr * g for t, g in zip(ts, grads)]
    return [tuple(new[2 * i:2 * i + 2]) for i in range(len(params))], loss


def check_mlp(world, dp, tp, dims, batch, dev, *, lr=0.01, rtol=1e-4,
              param_rtol=None, seed=0):
    """``make_tp_mlp_train_step`` at (dp, tp) for one step against the plain
    single-device step on the whole batch (f32)."""
    groups = mesh_groups(world, dp, tp)
    i, j = groups.dp_index, groups.tp_index
    gen = torch.Generator().manual_seed(seed)
    full = [(w.to(dev), b.to(dev)) for w, b in init_mlp(gen, dims,
                                                         device="cpu")]
    x = _randn(gen, (batch, dims[0]), 1.0, torch.float32, dev)
    y = _randn(gen, (batch,), 1.0, torch.float32, dev)
    mb = batch // dp
    step = make_tp_mlp_train_step(groups, lr)
    shard = mlp_tp_shard(full, j, tp)
    xs, ys = x[i * mb:(i + 1) * mb], y[i * mb:(i + 1) * mb]
    (got_p, loss), wall, launches = _run(lambda: step(shard, xs, ys), dev)
    want_p, want_loss = _mlp_step(full, x, y, lr)
    label = f"MLP step ({dp}, {tp})"
    _loss_close(label, loss.item(), want_loss.item(), rtol)
    got = [t for pair in got_p for t in pair]
    want = [t for pair in mlp_tp_shard(want_p, j, tp) for t in pair]
    if param_rtol is not None:
        _close(label, got, want, param_rtol)
    return dict(wall_s=wall, launches=launches, loss=loss.item(),
                oracle_loss=want_loss.item(), max_param_err=_err(got, want),
                ms=_steady_ms(lambda: step(shard, xs, ys), dev),
                oracle_ms=_steady_ms(lambda: _mlp_step(full, x, y, lr), dev))


# -------------------------------------------------------------- the world
def shapes(small: bool):
    """The world's sizes: llama2-7B width in f32, or small ones."""
    if small:
        t = dict(seq=32, emb=64, heads=4, ffn=128, dtype="float32")
        return dict(ring=(1, 4, 32, 64), tfm=t, moe=(16, 32, 16),
                    mlp=([16, 64, 64, 1], 32))
    t = dict(seq=2048, emb=4096, heads=32, ffn=11008, dtype="float32")
    return dict(ring=(1, 32, 2048, 128), tfm=t, moe=(4096, 11008, 2048),
                mlp=([512, 512, 256, 1], 2048))


def _world_max(rec: dict, group, dev) -> dict:
    """``rec`` with its ``max_*`` errors the largest over the group's
    ranks (each rank checks its own part)."""
    keys = sorted(k for k in rec if k.startswith("max_"))
    t = torch.tensor([rec[k] for k in keys], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.pg)
    return {**rec, **dict(zip(keys, t.tolist()))}


def run_world(backend, dev, small: bool) -> dict:
    """Every path over the whole world (see the module notes); the errors
    are the largest over the ranks."""
    n = backend.get_world_size()
    sz = shapes(small)
    world = backend.get_default_group()
    res = {"ring": check_ring(world, sz["ring"], torch.float32, dev)}
    meshes = ([(n // 2, 2)] if n % 2 == 0 and n > 2 else []) + [(1, n)]
    for dp, tp in meshes:
        cfg = tfm.TransformerConfig(batch=dp, **sz["tfm"])
        res[f"tp_{dp}x{tp}"] = check_tp(backend, dp, tp, cfg, dev)
    cfg = tfm.TransformerConfig(batch=4, **sz["tfm"])
    res["pp"] = check_pp(world, cfg, 4, dev)
    emb, ffn, tokens = sz["moe"]
    res["moe"] = check_moe(world, moe.MoeConfig(emb, ffn, n), tokens, dev)
    dims, batch = sz["mlp"]
    for dp, tp in meshes:
        res[f"mlp_{dp}x{tp}"] = check_mlp(backend, dp, tp, dims, batch, dev)
    return {k: _world_max(v, world, dev) for k, v in res.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="small widths (a CPU rehearsal), not llama2-7B's")
    args = ap.parse_args(argv)
    backend = DistBackend(args.device)
    backend.initialize()
    try:
        res = run_world(backend, backend.device, args.small)
        backend.barrier()
    finally:
        backend.shutdown()
    if backend.rank == 0:
        dev = (torch.cuda.get_device_name(0) if args.device == "cuda"
               else "cpu")
        print(json.dumps({"world": backend.world, "device": dev, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
