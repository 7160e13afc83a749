"""Ring attention: sequence-parallel flash attention over a group (port of
``param_tpu/ops/ring_attention.py``).

The sequence is sharded over the n ranks of a group; each rank keeps its
query shard and the key / value shards travel round the ring:

    step 0:  K6 of the local Q against the local K, V (causal when causal:
             the diagonal block), with its lse;
    step t:  K, V hop one rank on (:func:`~param_tpu_torch.models.parallel.
             ring_hop`), so the rank holds shard (me - t) mod n, and K6 runs
             bidirectional against it; the partial results merge by the
             log-sum-exp combine (:func:`merge`).

Under ``causal`` a step whose source shard is not below ``me`` is masked
(the reference sets its lse to -inf, which leaves the merge unchanged).
The port skips K6 on such a step, which changes no result; the shard is
still forwarded, so every rank makes the same n - 1 hops.

The merge runs in f32 on the port's (B, H, S) f32 lse (the reference's
128-lane lse layout is a TPU layout and is not ported), and the result is
cast to q's dtype once, at the end: in f32 this is the reference's
arithmetic.  Forward only, as in the reference.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch

from param_tpu_torch.backend.base import CommGroup
from param_tpu_torch.models.parallel import group_rank, ring_hop
from param_tpu_torch.ops.attention import _flash_forward


def merge(o: torch.Tensor, lse: torch.Tensor, o_t: torch.Tensor,
          lse_t: torch.Tensor):
    """Log-sum-exp combine of two normalized partial attentions: o, o_t (B,
    H, S, D) and their lse (B, H, S) f32 -> (o, lse) of the union."""
    lse_new = torch.logaddexp(lse, lse_t)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_t - lse_new)[..., None]
    return o * w_old + o_t * w_new, lse_new


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, scale: float, block_q: int = 1024,
                      block_k: int = 1024):
    """One step's K6 (its plain version on the CPU): the f32 output of q
    against one K, V shard, and its (B, H, S_q) lse."""
    o, lse = _flash_forward(q, k, v, causal=causal, scale=scale,
                            block_q=block_q, block_k=block_k,
                            return_lse=True)
    return o.float(), lse


def ring_attention_steps(q: torch.Tensor,
                         held: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                         me: int, n: int, *, causal: bool = False,
                         scale: Optional[float] = None, block_q: int = 1024,
                         block_k: int = 1024) -> torch.Tensor:
    """Rank ``me``'s output of the ring, given ``held``: the (k, v) shard
    the rank holds at each step t = 0..n-1 (shard (me - t) mod n).  The
    ring's schedule without the wire: :func:`ring_attention` feeds it hops,
    and one process can feed it every rank's shards in turn."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o = lse = None
    for t, (k_t, v_t) in enumerate(held):
        if t and causal and (me - t) % n >= me:
            continue  # masked: the merge would leave (o, lse) as they are
        o_t, lse_t = partial_attention(q, k_t, v_t, causal=causal and t == 0,
                                       scale=scale, block_q=block_q,
                                       block_k=block_k)
        o, lse = (o_t, lse_t) if o is None else merge(o, lse, o_t, lse_t)
    return o.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: CommGroup, *, causal: bool = False,
                   scale: Optional[float] = None, block_q: int = 1024,
                   block_k: int = 1024) -> torch.Tensor:
    """Flash attention over sequence shards: q, k, v are this rank's (B, H,
    S/n, D) shards (shard r on group rank r); returns its output shard."""
    n = group.size

    def held():
        kv = [k, v]
        for t in range(n):
            if t:
                kv = ring_hop(kv, group)
            yield kv

    return ring_attention_steps(q, held(), group_rank(group), n,
                                causal=causal, scale=scale, block_q=block_q,
                                block_k=block_k)
