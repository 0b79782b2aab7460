"""Host staging: one reused host buffer per decoder, and each scan's
arrays in one region of it, copied to the device at once.

A decoder (``api.Decoder``, ``parallel.batch.BatchDecoder``) owns one
:class:`HostStaging`: a host buffer that outlives its calls and only grows,
pinned where the decoder's device is CUDA. A call starts with
:meth:`HostStaging.begin`, which waits (in a ``jpeggpu.copy_in.wait``
range) for the events recorded after the previous copies from the buffer,
so that nothing rewrites it while a copy from it may be in flight; the
call then lays its regions one after another from the buffer's start
(:meth:`HostStaging.region`). A region holds the arrays of one scan (the
word stream, which the native destuffer writes straight into it, the
segment tables, the packed Huffman tables and the symbol table) or a
decode's quantisation tables, each field :data:`ALIGN`-byte aligned. It
goes to the device in one non-blocking copy (:meth:`Region.to`), and the
device tensors are views of that copy. Without a staging (``build_inputs``
called alone, arrays staged by the JAX package: :func:`region` with
``staging=None``, :func:`pack`) a region is a pageable buffer of its own
and goes through the same copy.

The buffer holds one call's regions at a time, so a decoder, and the
staging it owns, is used from one thread: two threads calling one decoder
would write each other's regions. A staging thread beside the decode
thread would need a buffer of its own.

Counters, read by tests and ``chip_smoke.py``: ``h2d_copies``, the copies
to a device that :meth:`Region.to` issued; ``host_allocs``, staging
buffers allocated or grown.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .debug import scope

ALIGN = 16  # bytes; the kernels read the tables with 16-byte loads
h2d_copies = 0
host_allocs = 0

# the device tensor of each host dtype: the uint32 word stream goes as
# its int32 bit patterns
_DEVICE_DTYPE = {np.dtype(np.uint32): torch.int32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.uint8): torch.uint8}

Field = Tuple[str, object, Tuple[int, ...]]  # name, numpy dtype, shape


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _layout(fields: Sequence[Field]):
    """Each field's (offset, dtype, shape, bytes), aligned; total bytes."""
    out, end = {}, 0
    for name, dtype, shape in fields:
        dtype = np.dtype(dtype)
        n = math.prod(shape) * dtype.itemsize
        end = _aligned(end)
        out[name] = (end, dtype, tuple(shape), n)
        end += n
    return out, end


class Region:
    """Named arrays packed in one run of host bytes (``host``, uint8);
    ``region[name]`` is the field's numpy view."""

    __slots__ = ("host", "fields", "owner", "_bytes")

    def __init__(self, host: torch.Tensor, fields: Dict,
                 owner: Optional["HostStaging"] = None):
        self.host = host
        self.fields = fields
        self.owner = owner
        self._bytes = host.numpy()

    def arrays(self) -> Dict[str, np.ndarray]:
        """The staged state: the fields' numpy views by name, the symbol
        table (which the device alone reads) left out."""
        return {name: self[name] for name in self.fields if name != "symtab"}

    def __getitem__(self, name: str) -> np.ndarray:
        off, dtype, shape, n = self.fields[name]
        return self._bytes[off:off + n].view(dtype).reshape(shape)

    def to(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The region on ``device`` in one copy (non-blocking: from a
        pinned buffer it returns before the copy is done, and the owner
        records an event after it); per field a view of the copy."""
        global h2d_copies
        dev = self.host.to(device, non_blocking=True, copy=True)
        h2d_copies += 1
        if self.owner is not None:
            self.owner.copied(dev.device)
        return {name: dev[off:off + n].view(_DEVICE_DTYPE[dtype]).view(shape)
                for name, (off, dtype, shape, n) in self.fields.items()}


class HostStaging:
    """The host buffer one decoder stages through (see the module's
    docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._buf: Optional[torch.Tensor] = None
        self._used = 0
        self._events: Dict[torch.device, torch.cuda.Event] = {}

    def begin(self) -> None:
        """Start a call: wait until the previous copies from the buffer are
        done, then lay the call's regions from its start."""
        with scope("jpeggpu.copy_in.wait", self.device):
            for event in self._events.values():
                event.synchronize()
        self._used = 0

    def region(self, fields: Sequence[Field]) -> Region:
        """The next region of the call, for ``fields``. Where the buffer is
        too small it is replaced by one of the next power of two bytes that
        holds the call so far: the regions laid already stay in the old
        one, and the next call of that size fits."""
        layout, size = _layout(fields)
        start = self._used
        if self._buf is None or start + size > self._buf.numel():
            global host_allocs
            cap = 1 << max(start + size - 1, 0).bit_length()
            self._buf = torch.empty(cap, dtype=torch.uint8,
                                    pin_memory=self._pin)
            host_allocs += 1
        self._used = _aligned(start + size)
        return Region(self._buf[start:start + size], layout, self)

    def copied(self, device: torch.device) -> None:
        """Record, on ``device``'s current stream, that a copy from the
        buffer was issued: :meth:`begin` waits for it."""
        if not self._pin:
            return
        event = self._events.get(device)
        if event is None:
            event = self._events[device] = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))

    def release(self) -> None:
        """Wait for the copies from the buffer and let it go."""
        for event in self._events.values():
            event.synchronize()
        self._buf = None
        self._used = 0


def region(fields: Sequence[Field],
           staging: Optional[HostStaging] = None) -> Region:
    """A region for ``fields``: the next one of ``staging``, or without one
    a pageable buffer of its own."""
    if staging is not None:
        return staging.region(fields)
    layout, size = _layout(fields)
    return Region(torch.empty(size, dtype=torch.uint8), layout)


def pack(arrays: Mapping[str, np.ndarray]) -> Region:
    """``arrays`` copied into a region of their own, in order."""
    reg = region([(name, a.dtype, a.shape) for name, a in arrays.items()])
    for name, a in arrays.items():
        reg[name][...] = a
    return reg
