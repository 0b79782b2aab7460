"""Decode over a mesh of devices: one image sharded, or a batch.

A :class:`Mesh` is a list of ``torch.device``s, one per shard. Devices
may repeat: four shards on one card is a mesh of four entries. The
shards run in one process, each on its device, and exchange
what the JAX package's collectives exchange through
:mod:`~jpeggpu_tpu_torch.parallel.collectives`
(:mod:`~jpeggpu_tpu_torch.parallel.segments`). A batch of images decodes
through :class:`BatchDecoder` / :func:`decode_batch`
(:mod:`~jpeggpu_tpu_torch.parallel.batch`), on one device or over a mesh.
A batch that spans processes, each decoding its own images on its own
devices, is :mod:`~jpeggpu_tpu_torch.parallel.multihost` (imported as a
module, not exported here; its weak-scaling harness is
:mod:`~jpeggpu_tpu_torch.parallel.weakscale`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of shards; ``devices[d]`` holds shard ``d``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (anything ``torch.device`` takes; repeats
    allowed). ``None`` means every visible CUDA device, and raises where
    there is none: the CPU is taken only when the caller names it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes the CUDA devices and none is available; "
                "pass devices=['cpu'] * D to run the plain versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


# after Mesh and make_mesh, which the batch module's imports need
from .batch import BatchDecoder, decode_batch  # noqa: E402

__all__ = ["BatchDecoder", "Mesh", "decode_batch", "make_mesh"]
