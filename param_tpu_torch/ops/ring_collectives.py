"""Kernel-tier ring collectives over per-rank shards (the port's
``param_tpu/ops/ring_collectives.py``).

The reference is single-controller: inside ``shard_map`` each device hands
its local array to a Pallas kernel that drives the ring with remote DMA.
Here the caller hands the list of per-rank shards, and gets one result per
rank back:

- :func:`ring_all_gather`: (local...) -> (n, local...) per rank, n - 1
  hops to the right (K8a);
- :func:`ring_all_reduce`: the reduce-scatter ring (K8b) then the ring
  all-gather of the reduced chunks (K8a, with the reference's roll by one
  folded into where each chunk lands); ``x.shape[0]`` must divide by n;
- :func:`ring_all_gather_bidir`: both ring directions at once (K8c);
- :func:`loopback_remote_copy`: each shard copied to itself behind the
  neighbour barrier (K8d), the one-card check of the ring's signalling.

Shards on the card (all on one card, or shard r on card r) go through the
kernels, which raise if a bounded wait runs out; shards on the CPU go
through the kernels' plain versions, which walk the same ring schedule.
These are the reference's own op API: nothing in the comms harness calls
them (its collectives are ``torch.distributed`` calls, as the reference's
are XLA collectives).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from param_tpu_torch.kernels import ring


def _on_card(shards: Sequence[torch.Tensor]) -> bool:
    kinds = {x.device.type for x in shards}
    if not shards or len(kinds) != 1 or kinds - {"cuda", "cpu"}:
        raise ValueError("shards must all lie on CUDA devices or all on the "
                         f"CPU, got {sorted(kinds)}")
    return kinds == {"cuda"}


def ring_all_gather(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """(local...) per rank -> (n, local...) per rank, gathered by the ring
    (``lax.all_gather(..., tiled=False)`` layout)."""
    shards = list(shards)
    if _on_card(shards):
        return ring.ring_all_gather_cuda(shards)
    return ring.ring_all_gather_plain(shards)


def ring_all_reduce(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Bandwidth-optimal ring all-reduce of the per-rank values; each
    shard's leading dimension must divide by the number of ranks."""
    shards = list(shards)
    if _on_card(shards):
        sums = ring.ring_reduce_scatter_cuda(shards, check=False)
        # rank d holds the sum of chunk (d + 1) % n: the gather's shift of
        # one puts chunk j at index j (the reference's roll by one); under
        # a CUDA-graph capture the check is ring.check_errors's, after a
        # replay
        gathered = ring.ring_all_gather_cuda(
            sums, shift=1,
            check=not torch.cuda.is_current_stream_capturing())
    else:
        gathered = ring.ring_all_gather_plain(
            ring.ring_reduce_scatter_plain(shards), shift=1)
    return [g.reshape(x.shape) for g, x in zip(gathered, shards)]


def ring_all_gather_bidir(
        shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Both-direction ring all-gather: (local...) -> (n, local...)."""
    shards = list(shards)
    if _on_card(shards):
        return ring.ring_all_gather_bidir_cuda(shards)
    return ring.ring_all_gather_bidir_plain(shards)


def loopback_remote_copy(
        shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each shard copied to itself through the ring's remote-write and
    barrier path (the reference runs it on a one-device mesh)."""
    shards = list(shards)
    if _on_card(shards):
        return ring.ring_loopback_cuda(shards)
    return ring.ring_loopback_plain(shards)
