"""In-process counterparts of the JAX collectives of the sharded decode.

The shards of a :class:`~jpeggpu_tpu_torch.parallel.Mesh` run in one
process, one after the other. Each collective takes one tensor per shard
(list index = shard index) and returns one per shard, on that shard's
device; each is named after the JAX primitive it stands for and follows its
semantics. A tensor moves between two cards with ``.to(device)``; on one
card that is no copy. Several hosts are ``torch.distributed``'s, not this
module's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def psum_scatter(xs: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``:
    the sum of the shards' tensors, cut along dimension 0 into one chunk per
    shard; chunk ``d`` goes to shard ``d``. The sum is taken in the tensors'
    own type, added in place into a copy of shard 0's chunk: int16 frames
    stay int16 (``torch.stack(...).sum(0)`` would promote to int64)."""
    n = xs[0].shape[0]
    if n % len(devices):
        raise ValueError(f"{n} rows do not split into {len(devices)} chunks")
    c = n // len(devices)
    out = []
    for d, dev in enumerate(devices):
        acc = xs[0][d * c:(d + 1) * c].to(dev, copy=True)
        for x in xs[1:]:
            acc += x[d * c:(d + 1) * c].to(dev)
        out.append(acc)
    return out


def all_gather(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``jax.lax.all_gather(x, axis)``: every shard gets the shards'
    tensors stacked on a new leading dimension."""
    return [torch.stack([x.to(dev) for x in xs]) for dev in devices]


def ppermute(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute(x, axis, perm)``: shard ``dst`` gets shard
    ``src``'s tensor for each ``(src, dst)`` of ``perm``; a shard that
    receives nothing gets zeros."""
    out = [torch.zeros_like(x, device=dev) for x, dev in zip(xs, devices)]
    for src, dst in perm:
        out[dst] = xs[src].to(devices[dst])
    return out


def psum(xs: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``jax.lax.psum(x, axis)``: every shard gets the sum of the shards'
    tensors (integer sums in int64)."""
    return [torch.stack([x.to(dev) for x in xs]).sum(0) for dev in devices]
