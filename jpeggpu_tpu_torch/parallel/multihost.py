"""Multi-process decode: ``torch.distributed`` wiring and a batch that
spans processes.

The port of ``jpeggpu_tpu/parallel/multihost.py``. Decode is data
parallel: each image's scan words, segment tables and Huffman and
quantisation tables travel with the image, so the hot path needs no
collective between processes. The multi-process story is wiring:
initialise the process group, know every process's devices, and have every
process decode its own local images through :class:`~jpeggpu_tpu_torch.
parallel.batch.BatchDecoder` over its own devices. Nothing crosses between
processes but one exchange of small integers per call.

Usage (the same program in every process):

    from jpeggpu_tpu_torch.parallel import multihost
    multihost.initialize("tcp://host0:29500", num_processes, process_id)
    dec = multihost.MultiHostBatchDecoder()
    local_planes = dec.decode(local_jpegs)   # this process's images only

The process group's backend is gloo: the one exchange is a few host
integers, and NCCL would also refuse two ranks on one card.
Weak-scaling harness: ``python -m jpeggpu_tpu_torch.parallel.weakscale``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..pipeline import build_plan
from ..reader import parse
from . import Mesh, make_mesh
from .batch import BatchDecoder, _geometry_key


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kwargs) -> None:
    """Initialise the process group on gloo (idempotent).

    With no arguments the rendezvous is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets
    them). ``coordinator_address`` is ``host:port`` (taken as
    ``tcp://host:port``) or any ``init_method`` URL, ``file://`` included;
    ``kwargs`` go to ``torch.distributed.init_process_group``.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


def process_index() -> int:
    """This process's rank; 0 where the group is not initialised."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the group; 1 where it is not initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _all_gather(values: Sequence[int]) -> np.ndarray:
    """Every process's ``values`` (int64), one row per process, by one
    ``all_gather`` of CPU tensors (gloo takes no others)."""
    mine = torch.tensor(list(values), dtype=torch.int64)
    if not dist.is_initialized():
        return mine.numpy()[None]
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    return torch.stack(rows).numpy()


@dataclasses.dataclass(frozen=True)
class GlobalMesh:
    """This process's devices and what it knows of the others'.

    A process can address only its own devices, so ``local`` is the
    :class:`~jpeggpu_tpu_torch.parallel.Mesh` it decodes on; the device
    count of every process, gathered once, makes the global size known,
    as JAX's ``mesh.devices.size`` is."""

    local: Mesh
    axis_name: str
    process_index: int
    process_count: int
    device_counts: Tuple[int, ...]

    @property
    def size(self) -> int:
        return sum(self.device_counts)


def global_mesh(axis_name: str = "data", *,
                devices: Optional[Sequence] = None) -> GlobalMesh:
    """This process's mesh over ``devices`` (``make_mesh``: by default
    every visible card, raising where there is none), with every process's
    device count. Collective: every process of the group calls it."""
    local = make_mesh(devices)
    counts = _all_gather([local.size])[:, 0]
    return GlobalMesh(local, axis_name, process_index(), process_count(),
                      tuple(int(v) for v in counts))


def _geometry_hash(plan) -> int:
    """A hash of the plan's geometry key that is the same in every process
    (Python's own ``hash`` of a string is not), as an int64."""
    digest = hashlib.sha256(repr(_geometry_key(plan.signature)).encode())
    return int.from_bytes(digest.digest()[:8], "little", signed=True)


class MultiHostBatchDecoder:
    """Data-parallel batched decode in every process of the group.

    Every process calls :meth:`decode` with its *local* images, all of one
    signature; the call is collective (one ``all_gather`` of each
    process's image count and geometry hash), and every process's images
    must share one geometry bucket (``batch._geometry_key``): where a peer
    passed another, every process raises ``ValueError`` instead of
    hanging. Each process then decodes its images through
    :class:`~jpeggpu_tpu_torch.parallel.batch.BatchDecoder` over its own
    mesh: merged where their Huffman tables are shared, else per image.
    Returns the local images' planes as numpy arrays, in local order.

    The JAX package pads each process's batch to the global per-process
    maximum, because its SPMD processes must all compile one executable;
    here each process compiles nothing per batch and decodes only its own
    images, and the results are the same without the padding, so there is
    none. The exchanged counts are kept in ``counts``.
    """

    def __init__(self, mesh=None, with_idct: bool = True,
                 axis_name: str = "data"):
        if mesh is None:
            mesh = global_mesh(axis_name)
        elif isinstance(mesh, Mesh):
            mesh = global_mesh(axis_name, devices=mesh.devices)
        self.mesh = mesh
        self.with_idct = with_idct
        self._batch = BatchDecoder(mesh=mesh.local, with_idct=with_idct)
        self.counts: Tuple[int, ...] = ()

    def decode(self, local_datas: Sequence[bytes]) -> List[List[np.ndarray]]:
        error = None
        key = 0
        if not local_datas:
            error = "each process must supply >= 1 image"
        else:
            plans = [build_plan(parse(d)) for d in local_datas]
            sig = plans[0].signature
            if any(p.signature != sig for p in plans):
                error = ("multi-host batch must share one geometry bucket; "
                         "group images by signature before calling decode")
            else:
                key = _geometry_hash(plans[0])
        table = _all_gather([len(local_datas), int(error is not None), key])
        if error is not None:
            raise ValueError(error)
        bad = [int(i) for i in np.flatnonzero(table[:, 1])]
        if bad:
            raise ValueError(f"process(es) {bad} could not join the "
                             f"multi-host batch")
        if np.any(table[:, 2] != key):
            raise ValueError(
                "multi-host batch must share one geometry bucket across "
                f"processes: process {process_index()} got geometry hashes "
                f"{table[:, 2].tolist()}")
        self.counts = tuple(int(v) for v in table[:, 0])
        return self._batch.decode(local_datas, plans)
