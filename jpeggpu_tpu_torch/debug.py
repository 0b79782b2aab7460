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

The decode stages run inside :func:`scope` ranges named ``jpeggpu.*``
(destuff, sync, write.<mode>, dc, idct_fused, deinterleave, idct), which
:func:`profile_trace` records.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_enabled = False


def set_debug(enabled: bool) -> None:
    global _enabled
    _enabled = bool(enabled)


def is_debug() -> bool:
    return _enabled


DEBUG_GOLDEN_MAX_PIXELS = 2_000_000


@contextlib.contextmanager
def scope(name: str, device: torch.device):
    """A named range around one decode stage: a ``record_function`` range
    for the profiler and, on a CUDA device, an NVTX range. Neither waits
    for the device."""
    nvtx = device.type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
