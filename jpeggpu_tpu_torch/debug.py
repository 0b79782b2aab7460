"""Debug mode and tracing: the port of ``jpeggpu_tpu/debug.py``.

Debug mode is the analog of the reference's ``is_debug`` global
(defs.hpp:105-106), which enables synchronous device-vs-host consistency
checks (decode_destuff.cu:242-253, :328-341). When it is on,
``Decoder.decode`` (planes returned to the host) also

- re-verifies the segment tables after parsing,
- compares the device destuff, where the plan uses it, with the host
  destuffer,
- for images of at most ``DEBUG_GOLDEN_MAX_PIXELS``, compares the planes
  bit for bit with the golden CPU decoder and re-derives the synchronised
  decoder states to check their invariants.

All checks raise :class:`jpeggpu_tpu_torch.errors.InternalError` on a
mismatch.

Tracing: every layer of the host path and every decode stage runs inside
a :class:`scope` range, which :func:`profile_trace` (or any
``torch.profiler`` window) records, and which is an NVTX range too where
the stage knows its CUDA device (all but ``jpeggpu.inputs``,
``jpeggpu.destuff.host`` and ``jpeggpu.symtab``). A range's parent is the
range that encloses it on the same host thread; a batch's ranges share its
``jpeggpu.batch`` root. The names and what each covers:

- ``jpeggpu.batch``: one ``BatchDecoder.decode`` call, the request's root;
- ``jpeggpu.parse``: one image's header walk (``reader.parse``), in
  ``BatchDecoder`` and ``Decoder.parse_header``;
- ``jpeggpu.plan``: one ``pipeline.build_plan`` (a batch's preliminary
  plan and a group's padded one; ``Decoder.parse_header``);
- ``jpeggpu.group``: a batch's grouping: the geometry keys, each group's
  ``group_pad`` and the check that its images share their tables;
- ``jpeggpu.copy_in.wait``: the host's wait, before a call writes over a
  decoder's staging buffer (``staging.HostStaging.begin``), for the copies
  from it that the previous call issued (at the start of
  ``BatchDecoder.decode``; in ``Decoder.transfer``, before
  ``jpeggpu.inputs``);
- ``jpeggpu.inputs``: one image's host staging (``pipeline.build_inputs``:
  the segment tables, the Huffman and symbol tables and the words, written
  into the staging buffer's regions);
- ``jpeggpu.destuff.host``: inside it, one scan's host destuff (the native
  pass: destuff, zero padding and byte swap);
- ``jpeggpu.merge``: one scan of a merged group (``merge_region``);
- ``jpeggpu.copy_in``: host arrays onto the device, one copy per scan's
  region and one for the quantisation tables (``stage_merged``,
  ``pipeline.stage_inputs``, so also ``Decoder.transfer``);
- ``jpeggpu.symtab``: one symbol-table build, that is one miss of
  ``convert._symbol_table``'s cache (its ``cache_info()`` counts hits and
  misses), inside ``jpeggpu.inputs`` or ``jpeggpu.merge`` (or
  ``jpeggpu.copy_in`` for arrays staged by the JAX package);
- ``jpeggpu.destuff``: the device destuff of a raw-staged scan;
- ``jpeggpu.sync``: a scan's synchronisation (``make_ctx``,
  ``sync_states``, ``symbol_offsets``): K1 once a round;
- ``jpeggpu.sync.read``: one host read of a round's flag or count in
  ``sync_states``, that is the round's wait for the device;
- ``jpeggpu.write.<mode>``: the write stage (K2, or K4-K8 under "tiles");
- ``jpeggpu.tail``: the tail of one scan (``scan_planes``): of a whole
  merged group in ``decode_merged``, of one image in ``decode_pipeline``;
- inside it ``jpeggpu.dc``, the DC un-delta, and ``jpeggpu.idct_fused``
  (K3), or with ``with_idct=False`` ``jpeggpu.deinterleave``; the sharded
  tail (``parallel/segments.py``) has ``jpeggpu.dc``,
  ``jpeggpu.deinterleave`` and ``jpeggpu.idct`` (K9) of its own;
- ``jpeggpu.to_host``: planes copied to numpy, the wait for the device
  included: a merged group's, one copy per component for all its images,
  or one image's (``BatchDecoder``, ``Decoder.decode``).

No range waits for the device but ``jpeggpu.sync.read``,
``jpeggpu.to_host`` and ``jpeggpu.copy_in.wait``, which wrap waits the
decode has anyway.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_enabled = False


def set_debug(enabled: bool) -> None:
    global _enabled
    _enabled = bool(enabled)


def is_debug() -> bool:
    return _enabled


DEBUG_GOLDEN_MAX_PIXELS = 2_000_000


class scope:
    """A named range around one stage, as a context manager: a
    ``record_function`` range while a profiler records (none otherwise:
    opening one costs microseconds of host time even when nothing records)
    and, where ``device`` is a CUDA device, an NVTX range. Neither waits
    for the device."""

    __slots__ = ("name", "nvtx", "ranged")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        self.name = name
        self.nvtx = device is not None and device.type == "cuda"
        self.ranged = None

    def __enter__(self) -> None:
        if torch.autograd._profiler_enabled():
            self.ranged = torch.profiler.record_function(self.name)
            self.ranged.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc) -> None:
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed decodes (the host
    and, where there is a CUDA device, its kernels) and write it into
    ``log_dir`` as a Chrome trace (``jpeggpu_<pid>_<ns>.json``), which
    Perfetto or ``chrome://tracing`` opens. The decode stages appear under
    their ``jpeggpu.*`` names."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the kernels end inside the trace
    prof.export_chrome_trace(os.path.join(
        log_dir, f"jpeggpu_{os.getpid()}_{time.time_ns()}.json"))
