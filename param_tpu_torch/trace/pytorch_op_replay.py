"""ATen-op-level compute replay of PyTorch execution traces (the port's
``param_tpu/trace/pytorch_op_replay.py``).

PARAM rebuilds a TorchScript callable per trace node and replays the
compute graph of a recorded PyTorch ET (``et_replay/tools/et_replay.py:829``
``build_func``, ``:891`` ``get_tensor_from_storage``, ``:468-560``
``extract_subgraph``).  This module answers the same question, what a
model's recorded op stream costs on this card, by mapping each ``aten::*``
op to a PyTorch callable (``_ATEN``).

Node selection follows PARAM: the top-most nodes with a non-empty
``op_schema`` (``execution_trace.py:278-291``), in node-id order, windowed
to the first ``ProfilerStep`` interval when the trace spans several steps
(``et_replay.py:535-542``).  An input tensor no earlier op produced is
materialized from its metadata: floats from ``np.random.default_rng(tensor
id)``, ints as ones (safe indices), bools as true, bit for bit as the JAX
package materializes them.

Each impl computes what the JAX package's impl computes, which is not
always aten's: dropout is the identity, ``aten::to`` keeps the dtype,
factory ops make floats, the fbgemm lookups are uniform-bag surrogates over
the flat weight blob.  Impls never write into their inputs: every output is
a new tensor or a view, so the registry behaves as the JAX package's
immutable one.

- **discrete mode** (:meth:`PyTorchOpReplay.replay`): each op once untimed,
  then once timed; on the card the timed call lies between two CUDA events
  after a synchronisation (the JAX package's host clock around
  ``block_until_ready``), on the CPU a host clock.
- **fused attention** (``fuse="attention"`` / ``"attention-train"``): the
  windows :mod:`.attention_fusion` finds replay as one
  :func:`~param_tpu_torch.ops.attention.flash_attention` call each (K6 on
  the card) and, for ``attention-train``, one ``flash_attention_bwd`` (K7).
  A fused window that fails raises: it never becomes a skip.
- **chain mode** (:meth:`PyTorchOpReplay.build_chain`): one iteration of
  the supported stream, fused windows included, captured in a CUDA graph
  after one eager pass; ``chain(n)`` replays it ``n`` times.  An op the
  graph cannot take makes the build raise, naming it.  On the CPU (the
  tests) the same iteration runs eagerly.
- **codegen** (:meth:`PyTorchOpReplay.codegen`): a standalone PyTorch
  script of the op stream.

An op with no mapping, or a recorded variant an impl refuses
(:class:`UnsupportedOp`), takes the skip path with its reason, and the skip
config file is updated (``et_replay.py:355-390,458``).  Any other error
raises, naming the node.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from param_tpu_torch.trace.attention_fusion import (
    AttnBwdWindow, find_attention_bwd_windows, find_attention_windows,
)
from param_tpu_torch.trace.pytorch_et import (
    PtNode, PyTorchETrace, _torch_dtype, is_tensor_list_slot,
    is_tensor_slot, tensor_key,
)
from param_tpu_torch.utils.device import resolve_device
from param_tpu_torch.utils.sizes import percentile

log = logging.getLogger(__name__)


class UnsupportedOp(Exception):
    """Raised by an impl when a recorded variant has no mapping."""


# --------------------------------------------------------------------------
# dtype / argument plumbing
# --------------------------------------------------------------------------

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "byte": torch.uint8, "char": torch.int8,
}


def slot_dtype(type_token: str) -> torch.dtype:
    """The dtype a tensor slot's type token names (float32 for any
    other)."""
    return _TORCH_DTYPES.get(_torch_dtype(type_token), torch.float32)


def materialize(shape, dtype: torch.dtype, seed: int,
                device) -> torch.Tensor:
    """A tensor made from its metadata: floats ``default_rng(seed).random``
    in f32, rounded to ``dtype`` (round to nearest even, as numpy's cast);
    bools true; other ints ones."""
    shape = tuple(int(d) for d in shape)
    if dtype.is_floating_point:
        arr = np.asarray(np.random.default_rng(seed).random(
            shape, dtype=np.float32))
        return torch.from_numpy(arr).to(dtype).to(device)
    return torch.ones(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# the ATen -> PyTorch registry
# --------------------------------------------------------------------------
# Each impl: (args, meta) -> list of per-output-slot values.  ``args`` holds
# tensors for tensor slots (None for nullptr), lists of tensors for
# GenericList[Tensor] slots, and raw literals otherwise.  ``meta`` holds the
# node's name, its recorded output shapes, the replay's float dtype and its
# device (where factory ops put their outputs).

_ATEN: Dict[str, Callable] = {}


def aten(*names):
    def deco(fn):
        for n in names:
            _ATEN[n] = fn
        return fn
    return deco


def _as_pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) > 1 else (v[0], v[0])
    return (v, v)


def _reduction(args_val):
    # torch reduction enum: 0 none, 1 mean, 2 sum
    return {0: "none", 1: "mean", 2: "sum"}.get(args_val, "mean")


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def _device(meta):
    return meta.get("device", "cpu")


@aten("aten::linear")
def _linear(a, meta):
    return [F.linear(a[0], a[1], a[2] if len(a) > 2 else None)]


@aten("aten::t")
def _t(a, meta):
    x = a[0]
    return [x.transpose(0, 1) if x.ndim == 2 else x]


@aten("aten::transpose", "aten::transpose_")
def _transpose(a, meta):
    return [a[0].transpose(int(a[1]), int(a[2]))]


@aten("aten::permute")
def _permute(a, meta):
    return [a[0].permute([int(d) for d in a[1]])]


@aten("aten::mm", "aten::bmm", "aten::matmul")
def _mm(a, meta):
    return [torch.matmul(a[0], a[1])]


@aten("aten::addmm")
def _addmm(a, meta):
    bias, m1, m2 = a[0], a[1], a[2]
    beta = a[3] if len(a) > 3 else 1
    alpha = a[4] if len(a) > 4 else 1
    return [beta * bias + alpha * torch.matmul(m1, m2)]


@aten("aten::baddbmm")
def _baddbmm(a, meta):
    beta = a[3] if len(a) > 3 else 1
    alpha = a[4] if len(a) > 4 else 1
    return [beta * a[0] + alpha * torch.matmul(a[1], a[2])]


@aten("aten::relu", "aten::relu_")
def _relu(a, meta):
    return [torch.relu(a[0])]


@aten("aten::clamp_min", "aten::clamp_min_")
def _clamp_min(a, meta):
    m = a[1]
    if isinstance(m, torch.Tensor):
        return [torch.maximum(a[0], m)]
    return [torch.clamp_min(a[0], m)]


@aten("aten::threshold_backward")
def _threshold_backward(a, meta):
    grad, self_, thr = a[0], a[1], a[2]
    return [torch.where(self_ > thr, grad, 0)]


def _gelu_approx(a, i):
    return "tanh" if len(a) > i and "tanh" in str(a[i]) else "none"


@aten("aten::gelu", "aten::gelu_")
def _gelu(a, meta):
    return [F.gelu(a[0], approximate=_gelu_approx(a, 1))]


@aten("aten::gelu_backward")
def _gelu_backward(a, meta):
    return [torch.ops.aten.gelu_backward(a[0], a[1],
                                         approximate=_gelu_approx(a, 2))]


@aten("aten::tanh")
def _tanh(a, meta):
    return [torch.tanh(a[0])]


@aten("aten::sigmoid")
def _sigmoid(a, meta):
    return [torch.sigmoid(a[0])]


@aten("aten::silu", "aten::silu_")
def _silu(a, meta):
    return [F.silu(a[0])]


@aten("aten::sum", "aten::mean")
def _sum_mean(a, meta):
    x = a[0]
    is_sum = meta["name"] == "aten::sum"
    if not is_sum and not x.is_floating_point():
        x = x.to(torch.float32)  # the mean of ints is a float
    dims = None
    keepdim = False
    if len(a) > 1 and isinstance(a[1], (list, tuple)) and a[1]:
        dims = tuple(int(d) for d in a[1] if int(d) < x.ndim) or None
        if len(a) > 2 and isinstance(a[2], bool):
            keepdim = a[2]
    fn = torch.sum if is_sum else torch.mean
    if dims is None:
        return [fn(x)]
    return [fn(x, dim=dims, keepdim=keepdim)]


@aten("aten::view", "aten::reshape", "aten::_unsafe_view")
def _view(a, meta):
    return [a[0].reshape([int(d) for d in a[1]])]


@aten("aten::flatten")
def _flatten(a, meta):
    x = a[0]
    start = int(a[1]) if len(a) > 1 else 0
    end = int(a[2]) if len(a) > 2 else -1
    if end < 0:
        end += x.ndim
    shape = list(x.shape[:start]) + [-1] + list(x.shape[end + 1:])
    return [x.reshape(shape)]


def _filled(shape, value, dtype, device):
    """``torch.full``, with a 16-bit float filled through f32 and rounded:
    a value out of its range becomes inf, as the JAX package's fill does
    (``torch.full`` refuses it on the card)."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.full(shape, value, dtype=torch.float32,
                          device=device).to(dtype)
    return torch.full(shape, value, dtype=dtype, device=device)


@aten("aten::zero_")
def _zero_(a, meta):
    return [torch.zeros_like(a[0])]


@aten("aten::fill_")
def _fill_(a, meta):
    x, v = a[0], a[1]
    if isinstance(v, torch.Tensor):
        return [v.to(x.dtype).expand(x.shape).clone()]
    return [_filled(x.shape, v, x.dtype, x.device)]


@aten("aten::add", "aten::add_", "aten::sub", "aten::sub_")
def _add_sub(a, meta):
    sign = 1 if meta["name"].startswith("aten::add") else -1
    alpha = a[2] if len(a) > 2 and not isinstance(a[2], (list, tuple)) else 1
    return [a[0] + sign * alpha * a[1]]


@aten("aten::mul", "aten::mul_")
def _mul(a, meta):
    return [a[0] * a[1]]


@aten("aten::div", "aten::div_")
def _div(a, meta):
    return [a[0] / a[1]]


@aten("aten::neg")
def _neg(a, meta):
    return [-a[0]]


@aten("aten::sqrt", "aten::sqrt_")
def _sqrt(a, meta):
    return [torch.sqrt(a[0])]


@aten("aten::rsqrt")
def _rsqrt(a, meta):
    return [torch.rsqrt(a[0])]


@aten("aten::pow")
def _pow(a, meta):
    return [a[0] ** a[1]]


@aten("aten::addcmul_", "aten::addcmul")
def _addcmul(a, meta):
    val = a[3] if len(a) > 3 else 1
    return [a[0] + val * a[1] * a[2]]


@aten("aten::addcdiv_", "aten::addcdiv")
def _addcdiv(a, meta):
    val = a[3] if len(a) > 3 else 1
    return [a[0] + val * a[1] / a[2]]


@aten("aten::softmax", "aten::_softmax")
def _softmax(a, meta):
    return [torch.softmax(a[0], dim=int(a[1]) if len(a) > 1 else -1)]


@aten("aten::log_softmax", "aten::_log_softmax")
def _log_softmax(a, meta):
    return [torch.log_softmax(a[0], dim=int(a[1]) if len(a) > 1 else -1)]


@aten("aten::_softmax_backward_data")
def _softmax_bwd(a, meta):
    grad, out, dim = a[0], a[1], int(a[2])
    return [(grad - torch.sum(grad * out, dim=dim, keepdim=True)) * out]


@aten("aten::_log_softmax_backward_data")
def _log_softmax_bwd(a, meta):
    grad, out, dim = a[0], a[1], int(a[2])
    return [grad - torch.exp(out) * torch.sum(grad, dim=dim, keepdim=True)]


def _pick(logp, target):
    """``logp[..., target]`` with the target reshaped to logp's batch."""
    target = target.reshape(logp.shape[:-1]).long()
    return torch.gather(logp, -1, target[..., None])[..., 0]


@aten("aten::cross_entropy_loss")
def _cross_entropy(a, meta):
    logits, target = a[0], a[1]
    reduction = _reduction(a[3] if len(a) > 3 else 1)
    ls = torch.log_softmax(logits, dim=-1)
    if target.shape == ls.shape and target.is_floating_point():
        # torch's probability-target form (soft labels, the input's shape)
        nll = -torch.sum(target * ls, dim=-1)
    else:
        nll = -_pick(ls, target)
    return [_reduce(nll, reduction)]


@aten("aten::nll_loss_forward")
def _nll_forward(a, meta):
    logp, target = a[0], a[1]
    reduction = _reduction(a[3] if len(a) > 3 else 1)
    nll = -_pick(logp, target)
    total_w = torch.full((), float(math.prod(nll.shape)), dtype=logp.dtype,
                         device=logp.device)
    return [_reduce(nll, reduction), total_w]


@aten("aten::nll_loss_backward")
def _nll_backward(a, meta):
    grad_out, logp, target = a[0], a[1], a[2]
    reduction = _reduction(a[4] if len(a) > 4 else 1)
    n, c = logp.shape[0], logp.shape[-1]
    target = target.reshape(logp.shape[:-1]).long()
    # a comparison, not F.one_hot: out-of-range classes give zero rows
    onehot = (target[..., None] == torch.arange(c, device=logp.device)) \
        .to(logp.dtype)
    scale = grad_out / n if reduction == "mean" else grad_out
    return [-onehot * torch.reshape(scale, (-1,) + (1,) * (logp.ndim - 1))]


@aten("aten::ones_like")
def _ones_like(a, meta):
    return [torch.ones_like(a[0])]


@aten("aten::zeros_like", "aten::empty_like")
def _zeros_like(a, meta):
    return [torch.zeros_like(a[0])]


@aten("aten::_foreach_add_", "aten::_foreach_add")
def _foreach_add(a, meta):
    ts, other = a[0], a[1]
    alpha = a[2] if len(a) > 2 else 1
    if isinstance(other, list):
        return [[t + alpha * o for t, o in zip(ts, other)]]
    return [[t + alpha * other for t in ts]]


@aten("aten::_foreach_mul_", "aten::_foreach_mul")
def _foreach_mul(a, meta):
    ts, other = a[0], a[1]
    if isinstance(other, list):
        return [[t * o for t, o in zip(ts, other)]]
    return [[t * other for t in ts]]


@aten("aten::copy_")
def _copy_(a, meta):
    dst, src = a[0], a[1]
    return [src.to(dst.dtype).expand(dst.shape).clone()]


@aten("aten::detach", "aten::detach_", "aten::clone", "aten::contiguous",
      "aten::alias", "aten::lift_fresh")
def _identity(a, meta):
    return [a[0]]


@aten("aten::to", "aten::_to_copy", "aten::type_as")
def _to(a, meta):
    # device / layout moves are the identity on a one-device replay, and
    # dtype casts keep the values (the JAX package's semantics)
    return [a[0]]


@aten("aten::as_strided")
def _as_strided(a, meta):
    x, size, stride = a[0], a[1], a[2]
    offset = int(a[3]) if len(a) > 3 and a[3] is not None else 0
    size = [int(s) for s in size]
    stride = [int(s) for s in stride]
    if not size:
        return [x.reshape(())]
    # a strided index map into the flattened base, built on the device; the
    # registry holds views, not storages, so it is clipped into the window
    idx = torch.full((1,), offset, dtype=torch.int64, device=x.device)
    for s, st in zip(size, stride):
        step = torch.arange(s, dtype=torch.int64, device=x.device) * st
        idx = (idx[..., None] + step).reshape(-1)
    idx = idx.clamp(0, max(x.numel() - 1, 0)).reshape(size)
    return [x.reshape(-1)[idx]]


@aten("aten::expand")
def _expand(a, meta):
    x, sizes = a[0], [int(s) for s in a[1]]
    shape = list(x.shape)
    # align trailing dims; -1 keeps the existing size
    full = [1] * (len(sizes) - len(shape)) + shape
    out = [f if s == -1 else s for s, f in zip(sizes, full)]
    return [x.reshape(full).expand(out)]


@aten("aten::cat", "aten::concat")
def _cat(a, meta):
    return [torch.cat(a[0], dim=int(a[1]) if len(a) > 1 else 0)]


@aten("aten::stack")
def _stack(a, meta):
    return [torch.stack(a[0], dim=int(a[1]) if len(a) > 1 else 0)]


@aten("aten::flatten_dense_tensors")
def _flatten_dense(a, meta):
    return [torch.cat([t.reshape(-1) for t in a[0]])]


@aten("aten::unflatten_dense_tensors")
def _unflatten_dense(a, meta):
    flat, like = a[0], a[1]
    outs, off = [], 0
    for t in like:
        n = t.numel() if t.ndim else 1
        outs.append(flat[off:off + n].reshape(t.shape))
        off += n
    return [outs]


@aten("aten::embedding")
def _embedding(a, meta):
    return [a[0][a[1].long()]]


def _norm_stats(x, axes):
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, correction=0, keepdim=True)
    return mu, var


@aten("aten::layer_norm")
def _layer_norm(a, meta):
    x = a[0]
    nshape = [int(d) for d in a[1]]
    axes = tuple(range(x.ndim - len(nshape), x.ndim))
    eps = a[4] if len(a) > 4 and isinstance(a[4], float) else 1e-5
    mu, var = _norm_stats(x, axes)
    out = (x - mu) / torch.sqrt(var + eps)
    if len(a) > 2 and a[2] is not None:
        out = out * a[2]
    if len(a) > 3 and a[3] is not None:
        out = out + a[3]
    return [out]


def _conv_fwd(x, w, stride, padding, dilation, groups):
    return F.conv2d(x, w, None, stride=_as_pair(stride),
                    padding=_as_pair(padding), dilation=_as_pair(dilation),
                    groups=int(groups))


@aten("aten::conv2d", "aten::convolution", "aten::_convolution")
def _conv2d(a, meta):
    x, w, b = a[0], a[1], a[2]
    stride, padding, dilation = a[3], a[4], a[5]
    if meta["name"] == "aten::conv2d":
        groups = a[6] if len(a) > 6 else 1
    else:  # convolution(..., transposed, output_padding, groups)
        if a[6]:
            raise UnsupportedOp("transposed convolution")
        groups = a[8]
    out = _conv_fwd(x, w, stride, padding, dilation, groups)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return [out]


@aten("aten::convolution_backward")
def _conv_backward(a, meta):
    grad_out, x, w = a[0], a[1], a[2]
    stride, padding, dilation = a[4], a[5], a[6]
    transposed, groups = a[7], a[9]
    if transposed:
        raise UnsupportedOp("transposed convolution backward")
    gi, gw, _ = torch.ops.aten.convolution_backward(
        grad_out, x, w, None, list(_as_pair(stride)),
        list(_as_pair(padding)), list(_as_pair(dilation)), False, [0, 0],
        int(groups), [True, True, False])
    gb = torch.sum(grad_out, dim=(0, 2, 3))
    return [gi, gw, gb]


def _bn_stats(x, eps):
    axes = (0,) + tuple(range(2, x.ndim))
    mu = torch.mean(x, dim=axes)
    var = torch.var(x, dim=axes, correction=0)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    xhat = (x - mu.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    return xhat, mu, var, axes, shape


@aten("aten::batch_norm", "aten::cudnn_batch_norm", "aten::native_batch_norm")
def _batch_norm(a, meta):
    x, w, b, rm, rv = a[0], a[1], a[2], a[3], a[4]
    training = bool(a[5]) if len(a) > 5 else True
    eps = a[7] if len(a) > 7 and isinstance(a[7], float) else 1e-5
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if training or rm is None:
        xhat, mu, var, _, _ = _bn_stats(x, eps)
    else:
        mu, var = rm, rv
        xhat = (x - mu.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    out = xhat
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    if meta["name"] == "aten::batch_norm":
        return [out]
    save_invstd = 1.0 / torch.sqrt(var + eps)
    if meta["name"] == "aten::cudnn_batch_norm":
        reserve = torch.zeros((0,), dtype=torch.uint8, device=x.device)
        return [out, mu, save_invstd, reserve]
    return [out, mu, save_invstd]


@aten("aten::cudnn_batch_norm_backward", "aten::native_batch_norm_backward")
def _batch_norm_backward(a, meta):
    if meta["name"] == "aten::cudnn_batch_norm_backward":
        x, grad_out, w = a[0], a[1], a[2]
        eps = a[7] if len(a) > 7 and isinstance(a[7], float) else 1e-5
    else:  # native: (grad_out, input, weight, rm, rv, save_m, save_i,
        # train, eps, mask)
        grad_out, x, w = a[0], a[1], a[2]
        eps = a[8] if len(a) > 8 and isinstance(a[8], float) else 1e-5
    # recompute the batch stats from the input (training-mode backward)
    xhat, mu, var, axes, shape = _bn_stats(x, eps)
    n = float(math.prod(x.shape[i] for i in axes))
    gw = torch.sum(grad_out * xhat, dim=axes)
    gb = torch.sum(grad_out, dim=axes)
    wv = torch.ones_like(gw) if w is None else w
    invstd = 1.0 / torch.sqrt(var + eps)
    gi = ((wv * invstd).reshape(shape) / n) * (
        n * grad_out - gb.reshape(shape) - xhat * gw.reshape(shape))
    return [gi, gw, gb]


def _pool_dims(kernel, stride, padding):
    k = _as_pair(kernel)
    s = _as_pair(stride) if (isinstance(stride, (list, tuple)) and stride) \
        or isinstance(stride, int) else k
    p = _as_pair(padding)
    return k, s, p


@aten("aten::max_pool2d", "aten::max_pool2d_with_indices")
def _max_pool2d(a, meta):
    k, s, p = _pool_dims(a[1], a[2] if len(a) > 2 else None,
                         a[3] if len(a) > 3 else 0)
    out = F.max_pool2d(a[0], k, s, p)
    if meta["name"] == "aten::max_pool2d_with_indices":
        # the indices only feed the backward, which recomputes them
        return [out, torch.zeros(out.shape, dtype=torch.int64,
                                 device=out.device)]
    return [out]


@aten("aten::max_pool2d_with_indices_backward")
def _max_pool2d_backward(a, meta):
    grad, x = a[0], a[1]
    k, s, p = _pool_dims(a[2], a[3], a[4])
    _, idx = torch.ops.aten.max_pool2d_with_indices(x, k, s, p)
    return [torch.ops.aten.max_pool2d_with_indices_backward(
        grad, x, k, s, p, [1, 1], False, idx)]


@aten("aten::adaptive_avg_pool2d", "aten::_adaptive_avg_pool2d")
def _adaptive_avg_pool2d(a, meta):
    x, out_size = a[0], [int(d) for d in a[1]]
    h, w = x.shape[2], x.shape[3]
    oh, ow = out_size
    if (oh, ow) == (1, 1):
        return [torch.mean(x, dim=(2, 3), keepdim=True)]
    if h % oh == 0 and w % ow == 0:
        r = x.reshape(tuple(x.shape[:2]) + (oh, h // oh, ow, w // ow))
        return [torch.mean(r, dim=(3, 5))]
    raise UnsupportedOp(f"adaptive_avg_pool2d {h, w} -> {oh, ow}")


@aten("aten::_adaptive_avg_pool2d_backward",
      "aten::adaptive_avg_pool2d_backward")
def _adaptive_avg_pool2d_backward(a, meta):
    grad, x = a[0], a[1]
    h, w = x.shape[2], x.shape[3]
    oh, ow = grad.shape[2], grad.shape[3]
    if h % oh or w % ow:
        raise UnsupportedOp("non-divisible adaptive pool backward")
    g = grad / ((h // oh) * (w // ow))
    g = g[:, :, :, None, :, None].expand(
        tuple(grad.shape[:2]) + (oh, h // oh, ow, w // ow))
    return [g.reshape(x.shape)]


@aten("aten::ones", "aten::zeros", "aten::empty", "aten::empty_strided")
def _factory(a, meta):
    shape = [int(d) for d in a[0]] if isinstance(a[0], (list, tuple)) else []
    fill = torch.ones if meta["name"] == "aten::ones" else torch.zeros
    return [fill(shape, dtype=meta.get("float_dtype", torch.float32),
                 device=_device(meta))]


@aten("aten::full")
def _full(a, meta):
    shape = [int(d) for d in a[0]] if isinstance(a[0], (list, tuple)) else []
    return [_filled(shape, a[1], meta.get("float_dtype", torch.float32),
                    _device(meta))]


@aten("aten::arange")
def _arange(a, meta):
    lits = [x for x in a if isinstance(x, (int, float))]
    return [torch.arange(*lits[:3], device=_device(meta))]


@aten("aten::item")
def _item(a, meta):
    # a 0-d tensor on the device: a host read would synchronise (and break
    # a CUDA graph capture)
    return [a[0].reshape(-1)[0]]


def _along(x, dim, sl):
    return x[(slice(None),) * (dim % x.ndim) + (sl,)]


@aten("aten::slice")
def _slice(a, meta):
    x, dim = a[0], int(a[1])
    start = int(a[2]) if a[2] is not None else 0
    end = int(a[3]) if a[3] is not None else x.shape[dim]
    step = int(a[4]) if len(a) > 4 and a[4] is not None else 1
    end = min(end, x.shape[dim])
    if start < 0:
        start += x.shape[dim]
    if end < 0:
        end += x.shape[dim]
    return [_along(x, dim, slice(start, end, step))]


@aten("aten::slice_backward")
def _slice_backward(a, meta):
    grad, sizes, dim = a[0], [int(d) for d in a[1]], int(a[2])
    start = int(a[3]) if a[3] is not None else 0
    step = int(a[5]) if len(a) > 5 and a[5] is not None else 1
    if step != 1:
        raise UnsupportedOp("strided slice_backward")
    out = torch.zeros(sizes, dtype=grad.dtype, device=grad.device)
    _along(out, dim, slice(start, start + grad.shape[dim])).copy_(grad)
    return [out]


@aten("aten::unsqueeze")
def _unsqueeze(a, meta):
    return [a[0].unsqueeze(int(a[1]))]


@aten("aten::squeeze")
def _squeeze(a, meta):
    if len(a) > 1 and isinstance(a[1], int):
        x = a[0]
        return [x.squeeze(a[1]) if x.shape[a[1]] == 1 else x]
    return [a[0].squeeze()]


def _split_at(x, points, dim):
    """numpy-style split of ``x`` at ``points`` along ``dim`` (views)."""
    return list(torch.tensor_split(x, points, dim=dim))


@aten("aten::split")
def _split(a, meta):
    x = a[0]
    dim = int(a[2]) if len(a) > 2 else 0
    if isinstance(a[1], (list, tuple)):
        points = np.cumsum([int(s) for s in a[1]])[:-1].tolist()
    else:
        step = int(a[1])
        points = list(range(step, x.shape[dim], step))
    return [_split_at(x, points, dim)]


@aten("aten::chunk")
def _chunk(a, meta):
    # chunk(Tensor self, int chunks, int dim=0) -> Tensor[]; torch rounds
    # the section size up, so the last chunk may be short
    x = a[0]
    chunks = int(a[1])
    dim = int(a[2]) if len(a) > 2 else 0
    step = -(-x.shape[dim] // chunks)
    return [_split_at(x, list(range(step, x.shape[dim], step)), dim)]


@aten("aten::where")
def _where(a, meta):
    cond = a[0] if a[0].dtype == torch.bool else a[0] != 0
    return [torch.where(cond, a[1], a[2])]


@aten("aten::dropout", "aten::dropout_")
def _dropout(a, meta):
    # the identity (eval semantics): train-mode mask generation is a fused
    # RNG the recorded stream does not expose as an op of its own
    return [a[0]]


@aten("aten::native_dropout")
def _native_dropout(a, meta):
    return [a[0], torch.ones(a[0].shape, dtype=torch.bool,
                             device=a[0].device)]


@aten("aten::native_dropout_backward")
def _native_dropout_backward(a, meta):
    grad, mask, scale = a[0], a[1], a[2]
    return [grad * mask.to(grad.dtype) * scale]


@aten("aten::tanh_backward")
def _tanh_backward(a, meta):
    grad, out = a[0], a[1]
    return [grad * (1 - out * out)]


@aten("aten::native_layer_norm")
def _native_layer_norm(a, meta):
    x = a[0]
    nshape = [int(d) for d in a[1]]
    axes = tuple(range(x.ndim - len(nshape), x.ndim))
    eps = a[4] if len(a) > 4 and isinstance(a[4], float) else 1e-5
    mu, var = _norm_stats(x, axes)
    rstd = 1.0 / torch.sqrt(var + eps)
    out = (x - mu) * rstd
    if len(a) > 2 and a[2] is not None:
        out = out * a[2]
    if len(a) > 3 and a[3] is not None:
        out = out + a[3]
    return [out, mu, rstd]


@aten("aten::native_layer_norm_backward")
def _native_layer_norm_backward(a, meta):
    # (grad_out, input, normalized_shape, mean, rstd, weight, bias, mask):
    # the recorded mean / rstd are not read; the statistics are recomputed
    # from the input with eps 1e-5, and the gradient of
    # (x - mu) / sqrt(var + eps) * w written out
    grad_out, x = a[0], a[1]
    nshape = [int(d) for d in a[2]]
    w = a[5] if len(a) > 5 else None
    axes = tuple(range(x.ndim - len(nshape), x.ndim))
    mu, var = _norm_stats(x, axes)
    std = torch.sqrt(var + 1e-5)
    xhat = (x - mu) / std
    wv = torch.ones(nshape, dtype=x.dtype, device=x.device) if w is None \
        else w
    bdims = tuple(range(x.ndim - len(nshape)))
    gw = torch.sum(grad_out * xhat, dim=bdims)
    dxhat = grad_out * wv
    gi = (dxhat - torch.mean(dxhat, dim=axes, keepdim=True)
          - xhat * torch.mean(dxhat * xhat, dim=axes, keepdim=True)) / std
    gb = torch.sum(grad_out, dim=bdims)
    return [gi, gw, gb]


@aten("aten::embedding_backward", "aten::embedding_dense_backward")
def _embedding_backward(a, meta):
    grad, idx, num_weights = a[0], a[1], int(a[2])
    flat_idx = idx.reshape(-1).long()
    flat_grad = grad.reshape(-1, grad.shape[-1])
    out = torch.zeros((num_weights, grad.shape[-1]), dtype=grad.dtype,
                      device=grad.device)
    return [out.index_add_(0, flat_idx, flat_grad)]


@aten("aten::_foreach_sqrt")
def _foreach_sqrt(a, meta):
    return [[torch.sqrt(t) for t in a[0]]]


@aten("aten::_foreach_div_", "aten::_foreach_div")
def _foreach_div(a, meta):
    other = a[1]
    if isinstance(other, list):
        return [[t / o for t, o in zip(a[0], other)]]
    return [[t / other for t in a[0]]]


@aten("aten::_foreach_lerp_", "aten::_foreach_lerp")
def _foreach_lerp(a, meta):
    w = a[2]
    if isinstance(w, list):
        return [[t + ww * (e - t) for t, e, ww in zip(a[0], a[1], w)]]
    return [[t + w * (e - t) for t, e in zip(a[0], a[1])]]


def _per_tensor_scalars(val, n):
    """A foreach ``value=`` argument: one scalar, or a list with one for
    each tensor (Adam's step-size variant)."""
    if isinstance(val, list):
        return val
    return [val] * n


@aten("aten::_foreach_addcmul_", "aten::_foreach_addcmul")
def _foreach_addcmul(a, meta):
    vals = _per_tensor_scalars(a[3] if len(a) > 3 else 1, len(a[0]))
    return [[t + v * x * y for t, x, y, v in zip(a[0], a[1], a[2], vals)]]


@aten("aten::_foreach_addcdiv_", "aten::_foreach_addcdiv")
def _foreach_addcdiv(a, meta):
    vals = _per_tensor_scalars(a[3] if len(a) > 3 else 1, len(a[0]))
    return [[t + v * x / y for t, x, y, v in zip(a[0], a[1], a[2], vals)]]


@aten("aten::narrow")
def _narrow(a, meta):
    x, dim, start, length = a[0], int(a[1]), int(a[2]), int(a[3])
    if start < 0:
        start += x.shape[dim]
    return [_along(x, dim, slice(start, start + length))]


@aten("aten::select")
def _select(a, meta):
    return [torch.select(a[0], int(a[1]), int(a[2]))]


@aten("aten::record_stream", "fbgemm::bounds_check_indices")
def _noop(a, meta):
    return []  # stream bookkeeping / in-place checks: no outputs


@aten("aten::pin_memory", "aten::resolve_conj", "aten::resolve_neg")
def _identity_move(a, meta):
    return [a[0]]


@aten("aten::numpy_T")
def _numpy_t(a, meta):
    return [a[0].permute(tuple(reversed(range(a[0].ndim))))]


@aten("aten::new_zeros", "aten::new_empty")
def _new_zeros(a, meta):
    shape = [int(d) for d in a[1]] if isinstance(a[1], (list, tuple)) else []
    return [torch.zeros(shape, dtype=a[0].dtype, device=a[0].device)]


@aten("aten::split_with_sizes")
def _split_with_sizes(a, meta):
    x, sizes = a[0], [int(s) for s in a[1]]
    dim = int(a[2]) if len(a) > 2 else 0
    return [_split_at(x, np.cumsum(sizes)[:-1].tolist(), dim)]


@aten("aten::cumsum")
def _cumsum(a, meta):
    return [torch.cumsum(a[0], dim=int(a[1]) if len(a) > 1 else 0)]


def _adv_index(lst):
    """torch's advanced-index list: a None (or string) slot is a full
    slice; None when every slot is."""
    if not isinstance(lst, list):
        lst = [lst]
    out = [None if (e is None or isinstance(e, str)) else e.long()
           for e in lst]
    return out if any(e is not None for e in out) else None


@aten("aten::index")
def _index(a, meta):
    idx = _adv_index(a[1])
    return [a[0] if idx is None else torch.ops.aten.index(a[0], idx)]


@aten("aten::_index_put_impl_", "aten::index_put_")
def _index_put(a, meta):
    idx = _adv_index(a[1])
    if idx is None:
        return [a[0]]
    accumulate = bool(a[3]) if len(a) > 3 and isinstance(a[3], bool) else False
    x, v = a[0], a[2]
    v = v.to(x.dtype) if isinstance(v, torch.Tensor) else _filled(
        (), v, x.dtype, x.device)
    return [torch.ops.aten.index_put(x, idx, v, accumulate)]


@aten("aten::binary_cross_entropy_with_logits")
def _bce_logits(a, meta):
    logits, target = a[0], a[1]
    reduction = _reduction(a[4] if len(a) > 4 else 1)
    per = (torch.clamp_min(logits, 0) - logits * target
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return [_reduce(per, reduction)]


@aten("aten::binary_cross_entropy_with_logits_backward")
def _bce_logits_bwd(a, meta):
    grad, logits, target = a[0], a[1], a[2]
    n = float(logits.numel())
    return [grad * (torch.sigmoid(logits) - target) / n]


# ---- fbgemm sparse plumbing (the DLRM production-trace op family) ------
# The trace records tensor SHAPES but not contents, and these ops' output
# layout depends on contents (CSR offsets, table dim maps).  The impls
# synthesize a uniform bag structure with the same row count and traffic as
# the recorded op and take the output shape from the trace
# (meta["out_shapes"]).  PARAM's TorchScript replay has the same fidelity
# limit (its materialized storage is random too, et_replay.py:891-941).


@aten("fbgemm::asynchronous_complete_cumsum")
def _fbgemm_cumsum(a, meta):
    t = a[0]
    return [torch.cat([torch.zeros((1,), dtype=t.dtype, device=t.device),
                       torch.cumsum(t, dim=0)])]


@aten("fbgemm::permute_2D_sparse_data")
def _fbgemm_permute_2d(a, meta):
    perm, lengths, values = a[0], a[1], a[2]
    p = perm.long().clamp(0, lengths.shape[0] - 1)
    return [lengths.index_select(0, p), values, None]


def _fbgemm_lookup(dev_weights, indices, out_shape):
    """A uniform-layout embedding-bag lookup over the flat fbgemm weight
    blob: gathers exactly len(indices) rows of total_D floats and sums them
    into (B, total_D) bags, the recorded op's row count and traffic."""
    b, total_d = int(out_shape[0]), int(out_shape[1])
    n_idx = indices.shape[0]
    rows = max(1, dev_weights.shape[0] // max(total_d, 1))
    table = dev_weights[: rows * total_d].reshape(rows, total_d)
    gathered = table[indices.long() % rows]  # (n_idx, total_D)
    bag = (torch.arange(n_idx, dtype=torch.int64, device=table.device)
           * b) // max(n_idx, 1)
    out = torch.zeros((b, total_d), dtype=table.dtype, device=table.device)
    return out.index_add_(0, bag, gathered)


@aten("fbgemm::dense_embedding_codegen_lookup_function")
def _fbgemm_dense_lookup(a, meta):
    return [_fbgemm_lookup(a[0], a[7], meta["out_shapes"][0])]


@aten("fbgemm::split_embedding_codegen_lookup_adagrad_function",
      "fbgemm::split_embedding_codegen_lookup_sgd_function",
      "fbgemm::split_embedding_codegen_lookup_rowwise_adagrad_function")
def _fbgemm_split_lookup(a, meta):
    return [_fbgemm_lookup(a[1], a[11], meta["out_shapes"][0])]


def supported_aten_ops() -> List[str]:
    return sorted(_ATEN)


# --------------------------------------------------------------------------
# the replayer
# --------------------------------------------------------------------------


@dataclass
class OpStat:
    count: int = 0
    lat_us: List[float] = field(default_factory=list)

    def total_us(self) -> float:
        return sum(self.lat_us)


def _float_leaves(outs):
    for o in outs:
        for leaf in (o if isinstance(o, list) else [o]):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                yield leaf


class PyTorchOpReplay:
    """Op-level compute replay of a PyTorch ET on ``device`` (the card
    unless the caller asks for the CPU).

    PARAM's counterpart: ``et_replay/tools/et_replay.py``'s ReplayManager in
    ``ReplayMode.COMP`` (``:468`` extract_subgraph, ``:829`` build_func).
    """

    def __init__(
        self,
        data: Dict[str, Any],
        max_ops: Optional[int] = None,
        skip_names: Optional[set] = None,
        skip_config_path: Optional[str] = None,
        mode: str = "comp",
        backend=None,
        target_rank: int = 0,
        auto_shrink: bool = True,
        triton_surrogate: bool = True,
        cast: Optional[str] = None,
        fuse: Optional[str] = None,
        max_tensor_bytes: Optional[int] = None,
        device="cuda",
    ):
        """``mode="comp"`` replays the ATen stream only (PARAM's
        ReplayMode.COMP); ``mode="full"`` also runs the
        ``record_param_comms`` nodes through ``backend`` at their recorded
        positions (ReplayMode.FULL, ``et_replay.py:512-524``).

        ``cast="bf16"``: the what-if precision, f32 / f64 tensors
        materialized as bf16 and the factory ops' floats in bf16 (shapes
        and ops stay the trace's).  ``fuse``: ``"attention"`` replays each
        forward attention window as one flash-attention call,
        ``"attention-train"`` the backward windows too.
        ``max_tensor_bytes``: shrink the fbgemm weight blobs above it to
        row surrogates (listed in the report)."""
        if mode not in ("comp", "full"):
            raise ValueError(f"mode must be comp or full, got {mode!r}")
        if mode == "full" and backend is None:
            raise ValueError("full mode needs a backend")
        if cast not in (None, "bf16", "bfloat16"):
            raise ValueError(f"cast must be None or bf16, got {cast!r}")
        if fuse not in (None, "attention", "attention-train"):
            raise ValueError(f"fuse must be None, attention or "
                             f"attention-train, got {fuse!r}")
        self.device = resolve_device(device)
        self._float_dtype = torch.bfloat16 if cast else torch.float32
        self.cast = bool(cast)
        self.et = PyTorchETrace(data)
        self.mode = mode
        self.triton_surrogate = triton_surrogate
        self.max_ops = max_ops
        self.skip_names = set(skip_names or ())
        self.skip_config_path = skip_config_path
        self.max_tensor_bytes = max_tensor_bytes
        self._shrunk: Dict[Tuple[int, int], Tuple[Tuple[int, ...],
                                                  Tuple[int, ...]]] = {}
        self.nodes: List[PtNode] = []
        self.registry: Dict[Tuple[int, int], Any] = {}
        self.stats: Dict[str, OpStat] = {}
        self.skipped: Dict[str, str] = {}  # name -> reason
        # (key, shape, dtype) -> tensor: set by build_chain so that a graph
        # capture reuses the eager pass's externals instead of copying them
        # from the host again
        self._kept: Optional[Dict[Any, torch.Tensor]] = None
        self._materialized: Dict[Tuple[int, int], torch.Tensor] = {}
        self._cur_shape: List[int] = []
        self._cur_node: Optional[PtNode] = None  # the chain's current op
        self._select_nodes()
        self.fused_windows: List[Any] = []
        self.fused_bwd_windows: List[Any] = []
        self._fused_skip: set = set()
        self._fused_emit: Dict[int, Any] = {}
        if fuse:
            self.fused_windows = find_attention_windows(self.nodes)
            if fuse == "attention-train":
                self.fused_bwd_windows = find_attention_bwd_windows(self.nodes)
            for w in (*self.fused_windows, *self.fused_bwd_windows):
                if w.skip_ids & self._fused_skip:
                    continue  # overlapping match: keep the earlier window
                self._fused_skip |= w.skip_ids
                self._fused_emit[w.anchor_id] = w
        self._comms = None
        if mode == "full":
            from param_tpu_torch.trace.replay import CommsReplay, ReplayParams

            self._comms = CommsReplay(backend, ReplayParams(
                trace_type="pytorch_et", target_rank=target_rank,
                auto_shrink=auto_shrink, num_replays=1,
                num_warmup_replays=0))
            self._comms.load(data)
            self._comm_ops = {op.id: op for op in self._comms.ops}

    # ------------------------------------------------------------ selection
    def _select_nodes(self) -> None:
        """Top-most op_schema nodes in id order, windowed to the first
        ProfilerStep interval (PARAM's extract_subgraph semantics)."""
        by_id = self.et.by_id
        children: Dict[int, List[PtNode]] = {}
        roots: List[PtNode] = []
        for n in self.et.nodes:
            if n.parent in by_id and n.parent != n.id:
                children.setdefault(n.parent, []).append(n)
            else:
                roots.append(n)
        picked: List[PtNode] = []
        step_ids: List[int] = []

        def dfs(n: PtNode) -> None:
            if "ProfilerStep" in n.name:
                step_ids.append(n.id)
            if n.is_operator():
                picked.append(n)
                return
            for c in sorted(children.get(n.id, []), key=lambda x: x.id):
                dfs(c)

        for r in sorted(roots, key=lambda x: x.id):
            dfs(r)
        picked.sort(key=lambda x: x.id)
        step_ids.sort()
        if len(step_ids) > 1:
            picked = [n for n in picked if step_ids[0] < n.id < step_ids[1]]
        # comp mode: comm records belong to the comm replayer; full mode
        # keeps them at their recorded positions
        if self.mode == "comp":
            picked = [n for n in picked if n.name != "record_param_comms"]
        if self.max_ops:
            picked = picked[: self.max_ops]
        self.nodes = picked

    # -------------------------------------------------------- tensor plumb
    def _materialize(self, key, type_token: str) -> torch.Tensor:
        dt = slot_dtype(type_token)
        if self.cast and dt in (torch.float32, torch.float64):
            dt = torch.bfloat16
        seed = 0 if key is None else key[0]
        shape = tuple(self._cur_shape)
        if self._kept is not None:
            got = self._kept.get((key, shape, dt))
            if got is None:
                got = self._kept[(key, shape, dt)] = materialize(
                    shape, dt, seed, self.device)
            return got
        return materialize(shape, dt, seed, self.device)

    def _resolve_tensor(self, desc, shape, type_token, shrinkable=False):
        key = tensor_key(desc)
        # a missing optional (nullptr) stays None; a real zero-size tensor
        # materializes as an empty one
        if key is None or "nullptr" in (type_token or ""):
            return None
        if key in self._shrunk:
            # surrogates keep their shrunk shape on every resolve
            return self.registry[key]
        self._cur_shape = [int(d) for d in shape]
        # fbgemm weight-blob surrogates: a float blob above
        # max_tensor_bytes, on its first materialization, keeps 1/factor of
        # its rows (the lookup wraps its indices mod rows, so the op's
        # output shape is unchanged)
        if (shrinkable and self.max_tensor_bytes
                and key not in self.registry
                and "float" in (type_token or "").lower()
                and self._cur_shape
                and math.prod(self._cur_shape) * 4 > self.max_tensor_bytes):
            orig = tuple(self._cur_shape)
            factor = -(-math.prod(orig) * 4 // self.max_tensor_bytes)
            self._cur_shape[0] = max(1, self._cur_shape[0] // factor)
            self._shrunk[key] = (orig, tuple(self._cur_shape))
            val = self._materialize(key, type_token)
            self.registry[key] = self._materialized[key] = val
            return val
        if key in self.registry:
            val = self.registry[key]
            want = tuple(self._cur_shape)
            if tuple(val.shape) == want:
                return val
            if val.numel() == math.prod(want):
                return val.reshape(want)
        val = self._materialize(key, type_token)
        self.registry[key] = self._materialized[key] = val
        return val

    def _resolve_args(self, node: PtNode) -> List[Any]:
        """Tensors in tensor slots, lists of them in list slots, literals
        elsewhere."""
        args: List[Any] = []
        for i, (v, t) in enumerate(zip(node.inputs, node.input_types)):
            shape = node.input_shapes[i] if i < len(node.input_shapes) else []
            if is_tensor_slot(t):
                args.append(self._resolve_tensor(
                    v, shape, t,
                    shrinkable=node.name.startswith("fbgemm::")
                    and "lookup" in node.name))
            elif is_tensor_list_slot(t):
                toks = t[len("GenericList["):-1].split(",")
                lst = []
                for j, d in enumerate(v):
                    tok = toks[min(j, len(toks) - 1)]
                    if d == "<None>" or "nullptr" in tok or tok == "None":
                        lst.append(None)  # torch index lists hold Nones
                        continue
                    lst.append(self._resolve_tensor(
                        d, shape[j] if j < len(shape) else [], tok))
                args.append(lst)
            else:
                # missing optionals: type "None" / value "<None>" (1.1.0)
                args.append(None if (t == "None" or v == "<None>") else v)
        return args

    def _register_outputs(self, node: PtNode, outs: List[Any]) -> None:
        for j, (v, t) in enumerate(zip(node.outputs, node.output_types)):
            if j >= len(outs):
                break
            if is_tensor_slot(t):
                key = tensor_key(v)
                if key is not None and outs[j] is not None:
                    self.registry[key] = outs[j]
            elif is_tensor_list_slot(t) and isinstance(outs[j], list):
                for d, val in zip(v, outs[j]):
                    key = tensor_key(d)
                    if key is not None:
                        self.registry[key] = val

    def _meta(self, node: PtNode) -> Dict[str, Any]:
        return {"name": node.name, "schema": node.op_schema,
                "out_shapes": node.output_shapes,
                "float_dtype": self._float_dtype, "device": self.device}

    # --------------------------------------------------------- fused windows
    def _fused_attention_outs(self, w):
        """One flash-attention call for a matched window: q / k / v resolve
        from the registry like any node input, so they chain off the
        upstream projections.  A view the kernels cannot read (last
        dimension not contiguous) is copied first."""
        from param_tpu_torch.kernels.flash_bwd import kernel_layout
        from param_tpu_torch.ops.attention import flash_attention

        if isinstance(w, AttnBwdWindow):
            return self._fused_attention_bwd_outs(w)
        q, k, v = (kernel_layout(self._resolve_tensor(*s[:3]))
                   for s in (w.q, w.k, w.v))
        return [flash_attention(q, k, v, causal=w.causal, scale=w.scale)]

    def _fused_attention_bwd_outs(self, w):
        """One ``flash_attention_bwd`` call for a backward window: q / k / v
        / dO resolve from the trace; the o / lse residuals the recorded
        eager graph never kept are synthesized as external inputs, with the
        JAX package's ids (1e9 + 2 x window index, + 1 for the lse).  The
        port's lse is its own (B, H, S_q) f32, and its 1e6 offset (the JAX
        package's) underflows P to exact zeros: the kernel's work does not
        depend on the values, and dq / dk / dv come out exactly zero.  The
        dV, dQ and dK^T matmul outputs the window replaces are registered,
        so downstream reshapes chain."""
        from param_tpu_torch.kernels.flash_bwd import kernel_layout
        from param_tpu_torch.ops.attention import flash_attention_bwd

        b, h, sq, sk, d = w.shape

        def get(slot, want4):
            t = self._resolve_tensor(slot[0], slot[1], slot[2])
            if slot[3]:  # the saved tensor is transposed (a cached K^T)
                t = t.transpose(-1, -2)
            return kernel_layout(t.reshape(want4))

        q = get(w.q, (b, h, sq, d))
        k = get(w.k, (b, h, sk, d))
        v = get(w.v, (b, h, sk, d))
        do = get(w.do, (b, h, sq, d))
        base = 1_000_000_000 + 2 * w.index
        o = self._resolve_tensor([base, base, 0, b * h * sq * d, 4,
                                  "synthetic"], (b, h, sq, d), w.do[2])
        lse = self._resolve_tensor([base + 1, base + 1, 0, b * h * sq, 4,
                                    "synthetic"], (b, h, sq), "Tensor(float)")
        lse = lse.float() + 1e6
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=w.causal, scale=w.scale)
        # register every replaced matmul's recorded output; the anchor's
        # own slot is returned for _register_outputs
        anchor_val = None
        for node_id, desc, shape, kind in w.outs:
            t = {"dq": dq, "dkT": dk, "dv": dv}[kind].reshape(b * h, -1, d)
            if kind == "dkT":
                t = t.transpose(-1, -2)
            val = t.reshape(tuple(shape))
            key = tensor_key(desc)
            if key is not None:
                self.registry[key] = val
            if node_id == w.anchor_id:
                anchor_val = val
        return [anchor_val]

    # ------------------------------------------------------------ execution
    def _call_for(self, node: PtNode) -> Optional[Tuple[str, Callable]]:
        """(stats label, a call computing the node's outputs) for a node the
        replay runs; None for a skipped node or the interior of a fused
        window."""
        if node.name in self.skip_names or node.name in self.skipped:
            return None
        if node.id in self._fused_skip:
            w = self._fused_emit.get(node.id)
            if w is None:
                return None  # interior of a fused attention window
            label = ("fused::flash_attention_bwd"
                     if isinstance(w, AttnBwdWindow)
                     else "fused::flash_attention")
            return label, lambda: self._fused_attention_outs(w)
        if node.kernel_backend == "triton":
            # PARAM compiles these from the trace's resources dir
            # (build_triton_func, et_replay_utils.py:215).  Pointwise /
            # reduction triton kernels are bandwidth-bound, so a
            # traffic-equivalent surrogate (read every tensor input, write
            # the recorded output shapes) keeps the op's memory cost;
            # triton_surrogate=False takes the skip path.
            if not self.triton_surrogate:
                self._skip(node, "PT2 triton kernel (CUDA source)")
                return None
            return f"triton:{node.name}", self._triton_call(node)
        if node.name not in _ATEN:
            self._skip(node, "no PyTorch mapping")
            return None
        args = self._resolve_args(node)
        impl, meta = _ATEN[node.name], self._meta(node)
        return node.name, lambda: impl(args, meta)

    def _triton_call(self, node: PtNode) -> Callable:
        """The traffic-equivalent stand-in for a PT2 triton kernel: the mean
        of every tensor input, broadcast into the recorded output shapes."""
        flat = []
        for a in self._resolve_args(node):
            for t in (a if isinstance(a, list) else [a]):
                if isinstance(t, torch.Tensor):
                    flat.append(t)
        shapes = [[int(d) for d in s] for s in node.output_shapes]

        def run():
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for t in flat:
                total = total + torch.mean(t.to(torch.float32))
            return [total.expand(s).clone() for s in shapes]

        return run

    def _run_outs(self, node: PtNode, call: Callable):
        """``call()``; an UnsupportedOp takes the skip path, any other
        error raises with the node named."""
        try:
            return call()
        except UnsupportedOp as e:
            self._skip(node, str(e))
            return None
        except Exception as e:
            e.add_note(f"replaying {node.name} (node {node.id})")
            raise

    def _timed(self, call: Callable):
        """(outputs, us) of one call: CUDA events after a synchronisation
        on the card, a host clock on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = call()
            end.record()
            end.synchronize()
            return outs, start.elapsed_time(end) * 1e3
        t0 = time.perf_counter()
        outs = call()
        return outs, (time.perf_counter() - t0) * 1e6

    def run_node(self, node: PtNode, timed: bool = True) -> Optional[float]:
        """Replay one node: once, and with ``timed`` once more, timed.
        Returns the timed call's us (0.0 untimed), None if skipped."""
        if node.name == "record_param_comms":  # only selected in full mode
            if node.name in self.skip_names:
                return None
            return self._run_comm(node, timed)
        got = self._call_for(node)
        if got is None:
            return None
        label, call = got
        outs = self._run_outs(node, call)
        if outs is None:
            return None
        dt = 0.0
        if timed:
            # the untimed call's outputs go back to the allocator first (a
            # backward window's registered gradients too), so the timed
            # call reuses their blocks instead of allocating (cudaMalloc)
            del outs
            w = self._fused_emit.get(node.id)
            for _, desc, _, _ in getattr(w, "outs", ()):
                self.registry.pop(tensor_key(desc), None)
            outs, dt = self._timed(call)
        self._register_outputs(node, list(outs))
        st = self.stats.setdefault(label, OpStat())
        st.count += 1
        if timed:
            st.lat_us.append(dt)
        return dt

    def _run_comm(self, node: PtNode, timed: bool) -> Optional[float]:
        """Full mode: a record_param_comms node through the backend at its
        recorded position (PARAM's ReplayMode.FULL), on the host clock."""
        from param_tpu_torch.trace.comms_trace import SKIP_OPS

        op = self._comm_ops.get(node.id)
        if op is None:
            return None  # init records are run up front by load()
        backend = self._comms.backend
        t0 = time.perf_counter()
        if op.comms in SKIP_OPS:
            if op.comms == "wait":
                backend.complete_ops()
            elif op.comms == "barrier":
                backend.barrier()
        else:
            backend.collective_fn[op.comms](self._comms.prep_op(op))
            if timed:
                backend.complete_ops()
        dt = (time.perf_counter() - t0) * 1e6
        st = self.stats.setdefault(f"comm:{op.comms}", OpStat())
        st.count += 1
        if timed:
            st.lat_us.append(dt)
        return dt

    def _skip(self, node: PtNode, reason: str) -> None:
        if node.name not in self.skipped:
            log.warning("skipping %s: %s", node.name, reason)
            self.skipped[node.name] = reason
            if self.skip_config_path:
                with open(self.skip_config_path, "w") as f:
                    json.dump({"skip nodes": self.skipped}, f, indent=1)

    def replay(self, iters: int = 1, timed: bool = True) -> Dict[str, Any]:
        """Discrete-mode replay: every selected node, per-op latency."""
        t0 = time.perf_counter()
        executed = 0
        for _ in range(max(1, iters)):
            for node in self.nodes:
                if self.run_node(node, timed=timed) is not None:
                    executed += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return self.report(executed, wall, iters)

    def report(self, executed: int, wall_s: float, iters: int):
        per_op = {
            name: {
                "count": st.count,
                "p50_us": percentile(st.lat_us, 50) if st.lat_us else 0.0,
                "total_us": st.total_us(),
            }
            for name, st in sorted(self.stats.items(),
                                   key=lambda kv: -kv[1].total_us())
        }
        return {
            "num_selected": len(self.nodes),
            "num_executed": executed,
            "num_skipped_names": len(self.skipped),
            "skipped": dict(self.skipped),
            "shrunk_tensors": {
                str(k): {"recorded": list(o), "surrogate": list(s)}
                for k, (o, s) in self._shrunk.items()
            },
            "wall_s": wall_s,
            "iters_per_s": iters / wall_s if wall_s > 0 else 0.0,
            "per_op": per_op,
            "fused_attention_windows": [
                {"anchor": w.anchor_id, "shape": list(w.shape),
                 "causal": w.causal, "ops_replaced": len(w.skip_ids)}
                for w in self.fused_windows
            ],
        }

    # ---------------------------------------------------------- chain mode
    def _iteration(self) -> torch.Tensor:
        """One pass over the supported stream (no comm nodes) from the
        registry as it stands; returns the sum of every float output
        weighted by 1e-30 (the JAX package's chain carry: finite, and a
        data edge from every op)."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for node in self.nodes:
            if node.name == "record_param_comms":
                continue
            self._cur_node = node
            got = self._call_for(node)
            if got is None:
                continue
            outs = self._run_outs(node, got[1])
            if outs is None:
                continue
            self._register_outputs(node, list(outs))
            for leaf in _float_leaves(outs):
                total = total + leaf.sum(dtype=torch.float32) * 1e-30
        return total

    def build_chain(self) -> Callable[[int], torch.Tensor]:
        """The whole supported op stream, fused windows included, as one
        CUDA graph; ``chain(n)`` replays it ``n`` times and returns the
        carry (a 0-d f32 tensor).

        One eager pass first materializes the external inputs (kept as the
        graph's static input buffers), builds the kernels and decides the
        skips; it runs on the capture stream.  Each iteration starts from
        an empty registry, the externals, and the previous iteration's
        carry added to the first float external (the JAX package's
        ``fori_loop`` carry).  An op the graph cannot take makes the build
        raise, naming it.  On the CPU the same iterations run eagerly."""
        on_card = self.device.type == "cuda"
        self._kept = {}
        self._materialized = {}
        self.registry = {}
        stream = torch.cuda.Stream(self.device) if on_card else None
        with (torch.cuda.stream(stream) if on_card
              else contextlib.nullcontext()):
            self._iteration()
        # the carry's target: the first float external the eager pass did
        # not overwrite, in registry order
        first = next((k for k, v in self.registry.items()
                      if v is self._materialized.get(k)
                      and v.is_floating_point()), None)
        base = self.registry.get(first)
        self.registry = {}
        carry = torch.zeros((), dtype=torch.float32, device=self.device)

        def iteration():
            self.registry = {}
            if first is not None:
                self.registry[first] = base + carry.to(base.dtype)
            carry.copy_(self._iteration())
            self.registry = {}

        if not on_card:
            def chain(n: int) -> torch.Tensor:
                carry.zero_()
                for _ in range(n):
                    iteration()
                return carry.clone()

            return chain

        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        self._cur_node = None
        try:
            with torch.cuda.graph(graph, stream=stream):
                iteration()
        except Exception as e:
            node = self._cur_node
            where = (f"op {node.name} (node {node.id})" if node is not None
                     else "the chain's carry")
            raise RuntimeError(f"{where} cannot be captured in a CUDA "
                               f"graph: {e}") from e

        def chain(n: int) -> torch.Tensor:
            carry.zero_()
            for _ in range(n):
                graph.replay()
            return carry.clone()

        self._graph = graph  # kept alive with its memory pool
        return chain

    def measure_chain_iteration(self, n: int = 8, reps: int = 3,
                                chain=None) -> float:
        """Milliseconds an iteration of the chain (``chain``, else one
        built here): the median over ``reps`` windows of ``chain(n)`` by
        CUDA events (a host clock on the CPU), after one untimed
        ``chain(1)``."""
        if chain is None:
            chain = self.build_chain()
        chain(1)
        samples = []
        for _ in range(reps):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(n)
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) / n)
            else:
                t0 = time.perf_counter()
                chain(n)
                samples.append((time.perf_counter() - t0) * 1e3 / n)
        return sorted(samples)[len(samples) // 2]

    # ------------------------------------------------------------- codegen
    def codegen(self, trace_name: str = "trace") -> str:
        """A standalone PyTorch script of the op stream: one ``_ATEN`` call
        a supported op, externals made from the same seeds as the replay's,
        each input resolved the replay's way (the tensor an earlier op
        produced, reshaped where its element count matches; else an
        external), one untimed then one timed iteration on ``--device``
        (``cuda`` by default), then ``replayed N ops OK``.  An op without a
        mapping becomes a comment, like the replay's skip path (PARAM:
        et_replay's ``--dump`` of ``benchmark_<rank>.py``,
        ``et_replay.py:392-400``)."""
        body: List[str] = []
        n_ops = 0

        def tensor_ref(desc, shape, tok):
            key = tensor_key(desc)
            if key is None or "nullptr" in (tok or ""):
                return "None"
            dt = str(slot_dtype(tok)).replace("torch.", "")
            return (f"_t({key!r}, {tuple(int(d) for d in shape)!r}, "
                    f"{dt!r})")

        for node in self.nodes:
            if node.name in self.skip_names or node.name not in _ATEN:
                why = ("pre-skip" if node.name in self.skip_names
                       else "no PyTorch mapping")
                body.append(f"    # skipped: {node.name} ({why})")
                continue
            arg_strs = []
            for i, (v, t) in enumerate(zip(node.inputs, node.input_types)):
                shape = (node.input_shapes[i]
                         if i < len(node.input_shapes) else [])
                if is_tensor_slot(t):
                    arg_strs.append(tensor_ref(v, shape, t))
                elif is_tensor_list_slot(t):
                    toks = t[len("GenericList["):-1].split(",")
                    elems = []
                    for j, d in enumerate(v):
                        tok = toks[min(j, len(toks) - 1)]
                        if d == "<None>" or "nullptr" in tok or tok == "None":
                            elems.append("None")
                        else:
                            elems.append(tensor_ref(
                                d, shape[j] if j < len(shape) else [], tok))
                    arg_strs.append("[" + ", ".join(elems) + "]")
                else:
                    lit = None if (t == "None" or v == "<None>") else v
                    arg_strs.append(repr(lit))
            slots = []
            for j, (v, t) in enumerate(zip(node.outputs, node.output_types)):
                if is_tensor_slot(t):
                    slots.append((j, tensor_key(v)))
                elif is_tensor_list_slot(t):
                    slots.append((j, [tensor_key(d) for d in v]))
            body.append(f"    _bind(_op({node.name!r}, [{', '.join(arg_strs)}]"
                        f", {node.output_shapes!r}), {slots!r})")
            n_ops += 1
        lines = [
            f'"""Generated from {trace_name} by param_tpu_torch\'s pt_et '
            'codegen.',
            "",
            "    python <this file> [--device cuda|cpu]",
            '"""',
            "import argparse",
            "import time",
            "",
            "import numpy as np",
            "import torch",
            "",
            "from param_tpu_torch.trace.pytorch_op_replay import _ATEN, "
            "materialize",
            "",
            "DEV = None",
            "R = {}  # tensor key -> the value of one iteration",
            "EXT = {}  # (key, shape, dtype) -> external input, made once",
            "",
            "",
            "def _t(key, shape, dtype):",
            "    val = R.get(key)",
            "    if val is not None:",
            "        if tuple(val.shape) == shape:",
            "            return val",
            "        if val.numel() == int(np.prod(shape)):",
            "            return val.reshape(shape)",
            "    ext = EXT.get((key, shape, dtype))",
            "    if ext is None:",
            "        ext = EXT[(key, shape, dtype)] = materialize(",
            "            shape, getattr(torch, dtype), key[0], DEV)",
            "    R[key] = ext",
            "    return ext",
            "",
            "",
            "def _op(name, args, out_shapes):",
            "    return _ATEN[name](args, {'name': name, 'schema': '',",
            "                              'out_shapes': out_shapes,",
            "                              'device': DEV})",
            "",
            "",
            "def _bind(outs, slots):",
            "    for j, key in slots:",
            "        if j >= len(outs):",
            "            break",
            "        if isinstance(key, list):",
            "            for k, v in zip(key, outs[j]):",
            "                if k is not None:",
            "                    R[k] = v",
            "        elif key is not None and outs[j] is not None:",
            "            R[key] = outs[j]",
            "",
            "",
            "def run_stream():",
            "    R.clear()",
        ] + (body or ["    pass"]) + [
            "",
            "",
            "def main(argv=None):",
            "    global DEV",
            "    ap = argparse.ArgumentParser()",
            "    ap.add_argument('--device', default='cuda')",
            "    ns = ap.parse_args(argv)",
            "    DEV = torch.device(ns.device)",
            "    if DEV.type == 'cuda' and not torch.cuda.is_available():",
            "        raise RuntimeError('CUDA is not available; pass "
            "--device cpu')",
            "    run_stream()  # materializes the externals",
            "    if DEV.type == 'cuda':",
            "        torch.cuda.synchronize(DEV)",
            "    t0 = time.perf_counter()",
            "    run_stream()",
            "    if DEV.type == 'cuda':",
            "        torch.cuda.synchronize(DEV)",
            "    print(f'one iteration: "
            "{(time.perf_counter() - t0) * 1e3:.3f} ms')",
            f"    print('replayed {n_ops} ops OK')",
            "",
            "",
            'if __name__ == "__main__":',
            "    main()",
        ]
        return "\n".join(lines) + "\n"
