"""Sharded decode of one image over a mesh of devices.

A :class:`Mesh` is a list of ``torch.device``s, one per shard. Devices
may repeat: four shards on one card is a mesh of four entries. The
shards run in one process, each on its device, and exchange
what the JAX package's collectives exchange through
:mod:`~jpeggpu_tpu_torch.parallel.collectives`.
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


__all__ = ["Mesh", "make_mesh"]
