"""Pre-LN transformer block: forward, train step and serving (port of
``param_tpu/models/transformer.py``).

One block: x + MHA(LN(x)), then x + FFN(LN(x)) with a tanh-approximated
gelu (``jax.nn.gelu``'s default).  Attention goes through
:func:`param_tpu_torch.ops.attention.flash_mha` (K6 forward, K7 backward)
or the unfused :func:`~param_tpu_torch.ops.attention.mha_reference`
(``attention="xla"``).

Training: :func:`make_train_step` is the reference's single-device step,
loss mean(out^2), gradients of every parameter (LN pairs included) by
autograd, plain SGD.

Serving: :func:`prefill` fills a static (B, H_kv, cache_len, d) KV cache
and :func:`decode_step` runs one token against it (GQA, optional sliding
window).  Weight-only int8 and int4 serving quantize the four matmul
weights; :func:`cast_int4_params` packs the int4 carriers once, ahead of
the decode loop, into K5's (K/2, N) nibble layout, so every int4
projection of a decode step runs K5 on the card.

Parameters are a plain dict, as in the reference: ``ln1`` / ``ln2``
(gamma, beta) pairs and the matrices ``wqkv`` (E, E + 2 H_kv d), ``wo``,
``w1``, ``w2``.

Multi-device (on :mod:`param_tpu_torch.models.parallel`'s collectives):

- Megatron dp x tp, :func:`make_sharded_train_step`: each tp rank holds
  :func:`tp_shard` (its heads' q, k and v columns, each block split by
  heads, and the matching rows of ``wo``; a column block of ``w1`` and the
  row block of ``w2``; the LN pairs whole) and runs attention on its own
  heads through ``flash_mha``.  The reference leaves the sharding to XLA
  and so takes the unfused attention (``attention="xla"``); explicit tp
  has no such limit and honours ``cfg.attention``.  Each LN output enters
  the projections through ``copy_to_group`` and the ``wo`` / ``w2``
  outputs leave through ``reduce_from_group``, so the residual stream and
  the LN gradients are the same on every tp rank.  The batch is split
  over dp, whose gradients are averaged.
- GPipe, :func:`make_pipeline_train_step`: one block a stage, microbatches
  forward by ring hops and their gradients back by reverse hops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from param_tpu_torch.backend.base import CommGroup
from param_tpu_torch.models.parallel import (
    MeshGroups, all_reduce_mean, copy_to_group, group_rank, reduce_from_group,
    ring_hop,
)
from param_tpu_torch.ops.attention import (
    decode_attention, flash_mha, mha_reference,
)
from param_tpu_torch.ops.matmul import matmul, matmul_int4, pack_nibbles
from param_tpu_torch.utils.dtypes import dtype_from_name

MATMUL_WEIGHTS = ("wqkv", "wo", "w1", "w2")


@dataclass(frozen=True)
class TransformerConfig:
    batch: int
    seq: int
    emb: int
    heads: int
    ffn: int
    causal: bool = True
    attention: str = "flash"  # flash | xla
    dtype: str = "bfloat16"
    kv_heads: Optional[int] = None  # < heads = GQA (llama-3 style)

    @property
    def head_dim(self) -> int:
        if self.emb % self.heads:
            raise ValueError(f"emb {self.emb} must divide by heads "
                             f"{self.heads}")
        return self.emb // self.heads

    @property
    def kvh(self) -> int:
        k = self.kv_heads or self.heads
        if self.heads % k:
            raise ValueError(f"heads {self.heads} must divide by kv heads {k}")
        return k


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                device="cuda") -> Dict:
    """Random block parameters: N(0, 1/din) matrices, unit LN gains, zero
    LN biases, in ``cfg.dtype``; drawn from ``gen`` on ``device``."""
    dt = dtype_from_name(cfg.dtype)
    e, ff = cfg.emb, cfg.ffn

    def w(din, dout):
        return (torch.randn((din, dout), generator=gen, device=device)
                / math.sqrt(din)).to(dt)

    def ln():
        return (torch.ones(e, dtype=dt, device=device),
                torch.zeros(e, dtype=dt, device=device))

    return {"ln1": ln(), "wqkv": w(e, e + 2 * cfg.kvh * cfg.head_dim),
            "wo": w(e, e), "ln2": ln(), "w1": w(e, ff), "w2": w(ff, e)}


def _split_heads(y: torch.Tensor, cfg: TransformerConfig, b: int, s: int):
    """(b, s, e + 2*kvh*d) qkv projection -> q (b, h, s, d), k / v
    (b, kvh, s, d), as strided views of ``y``."""
    e, d, kvh = cfg.emb, cfg.head_dim, cfg.kvh
    q, k, v = torch.split(y, [e, kvh * d, kvh * d], dim=-1)

    def heads(t, n):
        return t.reshape(b, s, n, d).transpose(1, 2)

    return heads(q, cfg.heads), heads(k, kvh), heads(v, kvh)


def _ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """LayerNorm as the reference computes it: f32 mean and population
    variance, eps 1e-5, cast to x's dtype before the affine part."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype) * gamma + beta


def _local_cfg(cfg: TransformerConfig, tp: int) -> TransformerConfig:
    """The shape of one tp rank's slice: H / tp heads, H_kv / tp kv heads,
    F / tp ffn lanes.  Raises ``ValueError`` unless tp divides all three."""
    if cfg.heads % tp or cfg.kvh % tp or cfg.ffn % tp:
        raise ValueError(f"tp {tp} must divide heads {cfg.heads}, kv heads "
                         f"{cfg.kvh} and ffn {cfg.ffn}")
    return replace(cfg, emb=cfg.emb // tp, heads=cfg.heads // tp,
                   kv_heads=cfg.kvh // tp, ffn=cfg.ffn // tp)


def _attend(params: Dict, x: torch.Tensor, cfg: TransformerConfig,
            tp: Optional[CommGroup] = None):
    """x + MHA(LN(x)) and the block's K and V heads; with a tp group, on
    this rank's :func:`tp_shard` and heads."""
    b, s, _ = x.shape
    hx = _ln(x, *params["ln1"])
    if tp is not None:
        hx, cfg = copy_to_group(hx, tp), _local_cfg(cfg, tp.size)
    qh, kh, vh = _split_heads(hx @ params["wqkv"], cfg, b, s)
    if cfg.attention == "flash":
        a = flash_mha(qh, kh, vh, cfg.causal, None)
    else:
        a = mha_reference(qh, kh, vh, causal=cfg.causal)
    out = a.transpose(1, 2).reshape(b, s, cfg.emb) @ params["wo"]
    if tp is not None:
        out = reduce_from_group(out, tp)
    return x + out, kh, vh


def _ffn(params: Dict, x: torch.Tensor, tp: Optional[CommGroup] = None):
    h2 = _ln(x, *params["ln2"])
    if tp is not None:
        h2 = copy_to_group(h2, tp)
    out = F.gelu(h2 @ params["w1"], approximate="tanh") @ params["w2"]
    if tp is not None:
        out = reduce_from_group(out, tp)
    return x + out


def block_apply(params: Dict, x: torch.Tensor, cfg: TransformerConfig,
                tp: Optional[CommGroup] = None):
    """One pre-LN block: x + MHA(LN(x)), then x + FFN(LN(x)).  With a tp
    group, ``params`` is this rank's :func:`tp_shard` and the result the
    whole block's, on every rank of the group."""
    return _ffn(params, _attend(params, x, cfg, tp)[0], tp)


def leaves(params: Dict):
    """The parameter tensors in a fixed order (LN pairs flattened).  Takes
    the reference's params too, whose LN pairs are tuples as well."""
    return [t for key in sorted(params)
            for t in (params[key] if isinstance(params[key], tuple)
                      else (params[key],))]


def _rebuild(params: Dict, ts):
    """A dict shaped like ``params`` holding ``ts`` (in leaves' order)."""
    it = iter(ts)
    return {key: (tuple(next(it) for _ in params[key])
                  if isinstance(params[key], tuple) else next(it))
            for key in sorted(params)}


def value_and_grad(params: Dict, x: torch.Tensor, cfg: TransformerConfig,
                   tp: Optional[CommGroup] = None):
    """(loss, grads): the reference's objective mean(block(x)^2) in f32 and
    its gradient for every parameter (a dict shaped like ``params``); with
    a tp group, of this rank's shard (see :func:`block_apply`)."""
    ts = [t.detach().requires_grad_(True) for t in leaves(params)]
    with torch.enable_grad():
        out = block_apply(_rebuild(params, ts), x, cfg, tp)
        loss = torch.mean(torch.square(out.float()))
        grads = torch.autograd.grad(loss, ts)
    return loss.detach(), _rebuild(params, grads)


def make_train_step(cfg: TransformerConfig, lr: float = 1e-4):
    """(params, x) -> (params', loss): forward, backward and an SGD update
    ``(w.float() - lr g.float()).to(w.dtype)`` of every parameter, as the
    reference's step.  Not in place: params' are new tensors and the
    caller's are left as they were (the reference's functional update)."""

    def step(params: Dict, x: torch.Tensor):
        loss, grads = value_and_grad(params, x, cfg)
        return _sgd(params, leaves(grads), lr), loss

    return step


def _sgd(params: Dict, grads, lr: float) -> Dict:
    """New parameters ``(w.float() - lr g.float()).to(w.dtype)``, ``grads``
    in leaves' order."""
    return _rebuild(params, [(w.float() - lr * g.float()).to(w.dtype)
                             for w, g in zip(leaves(params), grads)])


# ------------------------------------------------------ tensor parallel

def _tp_slices(cfg: TransformerConfig, tp_rank: int, tp: int):
    """Rank ``tp_rank``'s column slices of ``wqkv``'s q, k and v blocks
    (each split by heads), its row slice of ``wo`` and its ffn lanes."""
    local = _local_cfg(cfg, tp)
    e, kv = cfg.emb, cfg.kvh * cfg.head_dim
    qc, kc, fc = local.emb, kv // tp, local.ffn
    r = tp_rank
    qkv = (slice(r * qc, (r + 1) * qc), slice(e + r * kc, e + (r + 1) * kc),
           slice(e + kv + r * kc, e + kv + (r + 1) * kc))
    return qkv, slice(r * qc, (r + 1) * qc), slice(r * fc, (r + 1) * fc)


def tp_shard(params: Dict, cfg: TransformerConfig, tp_rank: int,
             tp: int) -> Dict:
    """Tensor-parallel rank ``tp_rank``'s parameters of ``tp`` (the
    reference's ``param_specs`` / ``place``): the q, k and v column blocks of
    its heads, concatenated; the matching rows of ``wo``; its column block
    of ``w1`` and row block of ``w2``; the LN pairs whole.  The reference's
    contiguous column split of ``wqkv`` would give rank 0 all of q, which
    explicit tp cannot use.  Raises ``ValueError`` unless tp divides the
    heads, the kv heads and the ffn width.  New contiguous tensors."""
    qkv, rows, lanes = _tp_slices(cfg, tp_rank, tp)
    return {"ln1": params["ln1"], "ln2": params["ln2"],
            "wqkv": torch.cat([params["wqkv"][:, c] for c in qkv], dim=1),
            "wo": params["wo"][rows].contiguous(),
            "w1": params["w1"][:, lanes].contiguous(),
            "w2": params["w2"][lanes].contiguous()}


def tp_gather(shards, cfg: TransformerConfig) -> Dict:
    """The whole parameters from every tp rank's :func:`tp_shard`, in rank
    order (the LN pairs of rank 0)."""
    local = _local_cfg(cfg, len(shards))
    kc = cfg.kvh * cfg.head_dim // len(shards)
    qkv = [torch.cat([s["wqkv"][:, a:b] for s in shards], dim=1)
           for a, b in ((0, local.emb), (local.emb, local.emb + kc),
                        (local.emb + kc, local.emb + 2 * kc))]
    return {"ln1": shards[0]["ln1"], "ln2": shards[0]["ln2"],
            "wqkv": torch.cat(qkv, dim=1),
            "wo": torch.cat([s["wo"] for s in shards]),
            "w1": torch.cat([s["w1"] for s in shards], dim=1),
            "w2": torch.cat([s["w2"] for s in shards])}


def make_sharded_train_step(groups: MeshGroups, cfg: TransformerConfig,
                            lr: float = 1e-4):
    """(shard, x) -> (shard', loss): the Megatron dp x tp step on this
    rank's :func:`tp_shard` and batch shard x (rows [i B / dp, (i + 1) B /
    dp) of dp rank i).  Its semantics are :func:`make_train_step`'s on the
    whole batch: the loss is the mean of block(x)^2 over the full batch,
    and every parameter takes SGD with the gradient averaged over dp.  Not
    in place."""
    _local_cfg(cfg, groups.tp.size)

    def step(params: Dict, x: torch.Tensor):
        loss, grads = value_and_grad(params, x, cfg, groups.tp)
        dp = groups.dp
        grads = all_reduce_mean(leaves(grads), dp.pg, dp.size)
        loss, = all_reduce_mean([loss], dp.pg, dp.size)
        return _sgd(params, grads, lr), loss

    return step


# ---------------------------------------------------- pipeline parallel

def init_stacked_params(gen: torch.Generator, cfg: TransformerConfig,
                        n_stages: int, device="cuda") -> Dict:
    """``n_stages`` blocks' parameters (:func:`init_params`, drawn in turn
    from ``gen``) stacked on a leading stage axis."""
    per = [init_params(gen, cfg, device) for _ in range(n_stages)]
    return _rebuild(per[0], [torch.stack(ts) for ts in
                             zip(*(leaves(p) for p in per))])


def stage_params(stacked: Dict, stage: int) -> Dict:
    """Stage ``stage``'s block of :func:`init_stacked_params`' tree."""
    return _rebuild(stacked, [t[stage] for t in leaves(stacked)])


def make_pipeline_train_step(group: CommGroup, cfg: TransformerConfig,
                             n_microbatches: int, lr: float = 1e-4):
    """(block, x) -> (block', loss): the GPipe step over ``group``, stage
    s = group rank s holding one block (:func:`stage_params`) and x the
    whole (M * mb, S, E) batch on every rank.

    Forward: at tick t stage s runs microbatch m = t - s (when 0 <= m < M)
    and every stage's output hops one stage on (stage 0 takes microbatch m
    of x in place of what it receives).  The last stage's loss is sum over
    m of mean(out_m^2) / M; it is differentiated there, never all-reduced
    before the backward.  Backward: the ticks again in reverse, stage s
    taking microbatch M - 1 - t + (S - 1 - s) with the output gradient
    that the reverse hop brought from stage s + 1, and sending its input's
    gradient back.  The reference also computes its bubble ticks, whose
    outputs never reach the loss; this step skips them.  Every stage takes
    SGD on its own block; the returned loss is summed over the stages (the
    last stage's).  Not in place."""
    n, m_count = group.size, n_microbatches

    def step(params: Dict, x: torch.Tensor):
        me = group_rank(group)
        mb = x.shape[0] // m_count
        ts = [t.detach().requires_grad_(True) for t in leaves(params)]
        block = _rebuild(params, ts)
        ticks = m_count + n - 1
        held = torch.zeros_like(x[:mb])
        saved = {}
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(ticks):
            m = t - me
            if 0 <= m < m_count:
                inp = (x[m * mb:(m + 1) * mb] if me == 0
                       else held.requires_grad_(True))
                with torch.enable_grad():
                    out = block_apply(block, inp, cfg)
                    if me == n - 1:
                        out_loss = torch.mean(torch.square(out.float()))
                        loss += out_loss.detach()
                        saved[m] = (inp, out_loss / m_count)
                    else:
                        saved[m] = (inp, out)
                held = out.detach()
            if t < ticks - 1:
                held, = ring_hop([held], group)
        for t in range(ticks):
            m = m_count - 1 - t + (n - 1 - me)
            if 0 <= m < m_count:
                inp, out = saved.pop(m)
                wrt = ts + ([inp] if me > 0 else [])
                torch.autograd.backward(out, None if me == n - 1 else held,
                                        inputs=wrt)
                if me > 0:
                    held = inp.grad
            if t < ticks - 1:
                held, = ring_hop([held], group, reverse=True)
        loss /= m_count
        dist.all_reduce(loss, group=group.pg)
        return _sgd(params, [t.grad for t in ts], lr), loss

    return step


def prefill(params: Dict, x: torch.Tensor, cfg: TransformerConfig,
            cache_len: int):
    """Run the block over the prompt and return (out, cache): K/V heads
    written into static (B, H_kv, cache_len, d) buffers."""
    b, s, _ = x.shape
    out, kh, vh = _attend(params, x, cfg)
    out = _ffn(params, out)
    shape = (b, cfg.kvh, cache_len, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
             "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
    cache["k"][:, :, :s] = kh
    cache["v"][:, :, :s] = vh
    return out, cache


def decode_step(params: Dict, cache: Dict, x: torch.Tensor, pos: int,
                cfg: TransformerConfig, window: Optional[int] = None):
    """One cached decode step: x is (B, 1, E), ``pos`` the write position
    (= tokens already in the cache).  The query attends cache[0..pos]
    (the last ``window`` entries with a window) through a position mask
    over the whole static cache; each kv head is read once for its query
    group.  Writes the new K/V into ``cache`` in place and returns
    (out, cache)."""
    b, _, e = x.shape
    h, d, kvh = cfg.heads, cfg.head_dim, cfg.kvh
    grp = h // kvh
    hx = _ln(x, *params["ln1"])
    q, k, v = torch.split(_mm(hx, params["wqkv"]), [e, kvh * d, kvh * d],
                          dim=-1)
    qh = q.reshape(b, kvh, grp, d)  # grouped query heads per kv head
    cache["k"][:, :, pos] = k.reshape(b, kvh, d).to(cache["k"].dtype)
    cache["v"][:, :, pos] = v.reshape(b, kvh, d).to(cache["v"].dtype)
    posn = torch.arange(cache["k"].shape[2], device=x.device)
    valid = posn <= pos
    if window is not None:
        valid = valid & (posn > pos - window)
    a = decode_attention(qh, cache["k"], cache["v"], valid).to(x.dtype)
    out = x + _mm(a.reshape(b, 1, e), params["wo"])
    h2 = _ln(out, *params["ln2"])
    out = out + _mm(F.gelu(_mm(h2, params["w1"]), approximate="tanh"),
                    params["w2"])
    return out, cache


# ------------------------------------------------- weight-only serving

def quantize_block_weights_int8(params: Dict) -> Dict:
    """Per-output-column max-abs int8 weights with f32 scales for the four
    matmul weights; LN parameters stay float."""
    def q(w):
        wf = w.float()
        absmax = wf.abs().amax(dim=0)
        scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        qw = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return (qw, scale)

    return {**params, **{k: q(params[k]) for k in MATMUL_WEIGHTS}}


def quantize_block_weights_int4(params: Dict, group: int = 128) -> Dict:
    """Group-wise int4 (``group`` input rows share a max-abs / 7 scale):
    (int8 carrier in [-7, 7] (din, dout), f32 scales (din // g, dout), g)
    for the four matmul weights; LN parameters stay float."""
    def q(w):
        din, dout = w.shape
        g = min(group, din)
        if din % g:
            raise ValueError(f"din {din} must divide by the group {g}")
        wf = w.float().reshape(din // g, g, dout)
        absmax = wf.abs().amax(dim=1)
        scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
        qv = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7)
        return (qv.to(torch.int8).reshape(din, dout), scale, g)

    return {**params, **{k: q(params[k]) for k in MATMUL_WEIGHTS}}


def cast_int4_params(params: Dict) -> Dict:
    """int8 carriers -> K5's nibble-packed (din // 2, dout) bytes, once,
    ahead of the decode loop (the counterpart of the reference's cast to
    XLA's s4); the values are not requantized."""
    return {k: ((pack_nibbles(v[0]), v[1], v[2])
                if isinstance(v, tuple) and len(v) == 3 else v)
            for k, v in params.items()}


def _mm(x: torch.Tensor, w):
    """Matmul taking plain weights, (int8, per-column scale) pairs or
    (int4, group scales, group) triples.

    - int8: a product of bf16 operands with f32 sums, then the f32 column
      scale, cast to x's dtype.
    - int4: K5 (:func:`~param_tpu_torch.ops.matmul.matmul_int4`) on the
      nibble-packed (din // 2, dout) weight of :func:`cast_int4_params`,
      x rounded to bf16, output in x's dtype.
    """
    lead = x.shape[:-1]
    if isinstance(w, tuple) and len(w) == 3:
        q, scale, _ = w
        if 2 * q.shape[0] != x.shape[-1]:
            raise ValueError(
                f"int4 weight {tuple(q.shape)} is not nibble-packed for "
                f"x {tuple(x.shape)}: pack it with cast_int4_params first")
        y = matmul_int4(x.reshape(-1, x.shape[-1]), q, scale,
                        out_dtype=x.dtype)
        return y.reshape(*lead, q.shape[-1])
    if isinstance(w, tuple):
        qw, scale = w
        y = matmul(x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                   qw.to(torch.bfloat16), out_dtype=torch.float32)
        return (y * scale).to(x.dtype).reshape(*lead, qw.shape[-1])
    return x @ w
