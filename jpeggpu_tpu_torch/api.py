"""Public decoder API: the five-phase protocol of the reference C API.

Maps the reference's contract (include/jpeggpu/jpeggpu.h:38-111) onto
PyTorch's execution model:

  reference                      here
  ---------                      ----
  jpeggpu_decoder_startup        Decoder(device=None, host_destuff=True)
  _parse_header                  Decoder.parse_header(data) -> ImgInfo
  _get_buffer_size               Decoder.get_buffer_size() -> bytes (the sum
                                 of the tensors the plan allocates)
  _transfer                      Decoder.transfer()  (host destuff + copy of
                                 scan words, tables, segment arrays; with
                                 host_destuff=False the raw scan bytes)
  _decode                        Decoder.decode(with_idct=True, device=False,
                                 donate=False) -> planes;
                                 Decoder.decode_into(outs) into caller-owned
                                 planes with a pitch
  _cleanup                       Decoder.cleanup() / context manager

``device=None`` is the CUDA device and raises where there is none; pass
``device="cpu"`` to run the kernels' plain versions (as the tests do).
The keywords are the JAX package's, with its meanings. With
``debug.set_debug(True)`` a decode to the host also runs the reference's
``is_debug`` cross-checks (:mod:`jpeggpu_tpu_torch.debug`).

The plan that ``parse_header`` builds carries the process default tuning
(``config.set_default_tuning``): that is how a ``Decoder`` or ``decode`` is
sent through the records write path (``Tuning(write_mode="tiles")``); the
entry points take no tuning argument.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import debug
from .errors import InternalError, InvalidArgument
from .pipeline import (
    DecodePlan,
    _destuff_host,
    build_inputs,
    build_plan,
    decode_pipeline,
    destuffed,
    plan_buffer_size,
    resolve_device,
    stage_inputs,
)
from .reader import parse
from .staging import HostStaging
from .utils.color import to_rgb


@dataclasses.dataclass
class ImgInfo:
    """Mirror of jpeggpu_img_info (jpeggpu.h:73-80)."""

    sizes_x: List[int]
    sizes_y: List[int]
    num_components: int
    subsampling: List[Tuple[int, int]]


class Decoder:
    """Reusable decoder handle (analog of jpeggpu_decoder_t).

    ``host_destuff=False`` stages each scan's raw bytes and destuffs them
    on the decoder's device (``ops/destuff.py``); the default destuffs on
    the host, as in the JAX package. The decoder stages through one host
    buffer of its own (``staging.HostStaging``, pinned on a CUDA device),
    which it reuses from image to image and lets go in :meth:`cleanup`."""

    def __init__(self, *, device=None, host_destuff: bool = True):
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._host_destuff = bool(host_destuff)
        self._logging = False
        self._plan: Optional[DecodePlan] = None
        self._data: Optional[bytes] = None
        self._staged = None
        self._device_inputs = None
        self._staging = HostStaging(self._device)

    # -- phase 0: logging toggle (jpeggpu.h:61-62) --
    def set_logging(self, enabled: bool) -> None:
        self._logging = bool(enabled)

    def _log(self, msg: str) -> None:
        if self._logging:
            print(msg, flush=True)

    # -- phase 1: host-only header parse (jpeggpu.h:81-85) --
    def parse_header(self, data: bytes) -> ImgInfo:
        with debug.scope("jpeggpu.parse", self._device):
            stream = parse(data, log=self._log if self._logging else None)
        with debug.scope("jpeggpu.plan", self._device):
            self._plan = build_plan(stream, host_destuff=self._host_destuff)
        self._data = data
        self._staged = None
        self._device_inputs = None
        comps = stream.components
        return ImgInfo(
            sizes_x=[c.size_x for c in comps],
            sizes_y=[c.size_y for c in comps],
            num_components=stream.num_components,
            subsampling=[(c.ss_x, c.ss_y) for c in comps],
        )

    def _require_plan(self) -> DecodePlan:
        if self._plan is None:
            raise InvalidArgument("parse_header must be called first")
        return self._plan

    # -- phase 2: device memory accounting (jpeggpu.h:87-88) --
    def get_buffer_size(self) -> int:
        """Device memory one decode allocates, in bytes; knowable from the
        header alone."""
        return plan_buffer_size(self._require_plan())

    def _host_inputs(self):
        if self._staged is None:
            plan = self._require_plan()
            # the previous image's copies from the staging buffer are done
            # before its host inputs are written over
            self._staging.begin()
            self._staged = build_inputs(self._data, plan, self._staging)
        return self._staged

    # -- phase 3: host->device staging (jpeggpu.h:90-93) --
    def transfer(self) -> None:
        self._device_inputs = stage_inputs(
            self._host_inputs(), self._require_plan(), self._device)

    # -- phase 4: decode (jpeggpu.h:102-109) --
    def _decode_planes(self, with_idct: bool,
                       donate: bool) -> Tuple[torch.Tensor, ...]:
        """The planes on the decoder's device, cropped to component size."""
        plan = self._require_plan()
        if self._device_inputs is None:
            self.transfer()
        for s, scan in enumerate(plan.stream.scans):
            self._log(f"scan {s}: {scan.num_subsequences} subsequences in "
                      f"{scan.num_segments} segment(s), "
                      f"{scan.num_mcus_x}x{scan.num_mcus_y} MCUs")
        scans, qtables = (self._device_inputs["scans"],
                          self._device_inputs["qtables"])
        if donate:
            # the handle lets go; the pipeline drops each scan as it goes
            self._device_inputs = None
        return decode_pipeline(plan.signature, scans, qtables, with_idct,
                               donate=donate)

    def decode(self, *, with_idct: bool = True, device: bool = False,
               donate: bool = False) -> List:
        """Run the device pipeline; returns per-component planes (uint8,
        cropped to component sizes — planar, possibly subsampled, exactly
        like the reference output contract jpeggpu.h:95-100). With
        ``with_idct=False`` the planes are the int16 dequantizable
        coefficients instead (DC un-deltaed, natural order within each
        8x8 block), cropped the same way.

        With ``device=True`` the planes are returned as tensors on the
        decoder's device with no copy to the host and no synchronisation,
        so they can be chained into further device work. The default
        materialises numpy arrays (one blocking copy) and, in debug mode
        (``debug.set_debug``), runs the consistency checks.

        With ``donate=True`` the staged device inputs are handed to the
        decode, the analog of the reference's caller-owned, decode-consumed
        d_tmp buffer: the handle drops them before the pipeline runs, and
        the pipeline lets go of each scan's words (or raw bytes) once its
        write stage has read them, so that the caching allocator reuses
        that memory for the tail. The next decode restages (``transfer``).
        """
        out = self._decode_planes(with_idct, donate)
        if device:
            return list(out)
        with debug.scope("jpeggpu.to_host", self._device):
            planes = [p.contiguous().cpu().numpy() for p in out]
        if debug.is_debug():
            self._debug_checks(planes, with_idct)
        return planes

    def decode_into(self, outs: Sequence[torch.Tensor], *,
                    with_idct: bool = True) -> List[torch.Tensor]:
        """Decode into caller-owned, reusable output tensors.

        The analog of the reference's output contract: decode() writes each
        component plane into user-provided device memory whose row pitch may
        exceed the component width (jpeggpu.h:95-100; pointer/pitch
        validation at decoder.cpp:336-353). ``outs`` is one 2-D tensor per
        component on the decoder's device, uint8 (int16 with
        ``with_idct=False``), each at least ``(size_y, size_x)``: larger
        extents are the pitch. The decoded plane lands in the top-left
        corner and every element past it is left as it was, as the
        reference leaves row tails untouched. Returns ``outs``' tensors
        themselves, so the same memory takes the next image.
        """
        comps = self._require_plan().stream.components
        if len(outs) != len(comps):
            raise InvalidArgument(
                f"expected {len(comps)} output planes, got {len(outs)}")
        want = torch.uint8 if with_idct else torch.int16
        for i, (o, c) in enumerate(zip(outs, comps)):
            if not isinstance(o, torch.Tensor) or o.device != self._device:
                raise InvalidArgument(
                    f"output plane {i} must be a tensor on {self._device}")
            if o.dim() != 2 or o.shape[0] < c.size_y or o.shape[1] < c.size_x:
                raise InvalidArgument(
                    f"output plane {i} shape {tuple(o.shape)} is smaller "
                    f"than the component ({c.size_y}, {c.size_x}) — pitch "
                    f"must be >= width (decoder.cpp:345-352)")
            if o.dtype != want:
                raise InvalidArgument(
                    f"output plane {i} dtype {o.dtype} != {want}")
        for o, p in zip(outs, self._decode_planes(with_idct, False)):
            o[:p.shape[0], :p.shape[1]].copy_(p)
        return list(outs)

    def _debug_checks(self, planes, with_idct: bool) -> None:
        """Synchronous consistency checks (reference is_debug analog)."""
        stream = self._require_plan().stream
        for scan in stream.scans:
            seg = scan.segments
            if int(seg[:, 1].sum()) != scan.num_subsequences or (
                    scan.num_segments and
                    not (seg[1:, 0] == np.cumsum(seg[:-1, 1])).all()):
                raise InternalError("segment table inconsistent")
        self._log("debug: segment tables consistent")
        self._destuff_cross_check()
        npix = stream.size_x * stream.size_y
        if with_idct and npix <= debug.DEBUG_GOLDEN_MAX_PIXELS:
            from . import golden

            ref = golden.decode(self._data)
            for i, (a, b) in enumerate(zip(ref, planes)):
                if not np.array_equal(a, b):
                    raise InternalError(
                        f"device output diverges from golden CPU decode "
                        f"(plane {i})")
            self._log("debug: device output matches golden CPU decoder")
        if npix <= debug.DEBUG_GOLDEN_MAX_PIXELS:
            self._sync_invariant_checks()

    def _destuff_cross_check(self) -> None:
        """If the plan uses the device destuff, synchronously compare its
        words with the host destuffer's — the analog of the reference's
        is_debug checks that verify the GPU destuff against the host parser
        (decode_destuff.cu:242-253, :328-341)."""
        from .ops import destuff

        plan = self._require_plan()
        inputs = self._host_inputs()
        buf = np.frombuffer(self._data, np.uint8)
        for si, (scan, sp) in enumerate(
                zip(plan.stream.scans, plan.signature.scans)):
            if sp.host_destuff:
                continue
            inp = inputs["scans"][si]
            dev = destuff.destuff_scan(
                torch.from_numpy(inp["raw"]).to(self._device),
                torch.from_numpy(inp["seg_sub_offset"]).to(self._device),
                sp.cfg.lanes).cpu().numpy().view(np.uint32)
            host = _destuff_host(buf, scan, sp.cfg.lanes)
            if not np.array_equal(dev, host):
                bad = int(np.flatnonzero(dev != host)[0])
                raise InternalError(
                    f"device destuff diverges from host destuffer "
                    f"(scan {si}, first word {bad}: device "
                    f"{dev[bad]:#010x} != host {host[bad]:#010x})")
            self._log(f"debug: scan {si} device destuff matches host")

    def _sync_invariant_checks(self) -> None:
        """Numeric-invariant sanitizer over the converged decoder states —
        the analog of the reference's routine compute-sanitizer runs
        (decoder.cpp:248-251's zero-inits exist only to satisfy initcheck).
        For every scan, re-derives the synchronised per-subsequence states
        on the decoder's device and checks the invariants any correct
        synchronisation must satisfy: bit positions end inside the owning
        subsequence's window, the component counter stays inside the MCU,
        the zig-zag index stays inside the data unit, and symbol counts are
        non-negative."""
        from . import constants as C
        from .ops import huffman as H

        plan = self._require_plan()
        staged = stage_inputs(self._host_inputs(), plan, self._device)
        for si, (sp, arrs) in enumerate(zip(plan.signature.scans,
                                            staged["scans"])):
            cfg = sp.cfg
            arrs = destuffed(arrs, cfg.lanes)
            ctx = H.make_ctx(cfg, arrs)
            p, c, z, n = H.sync_states(cfg, arrs, ctx)
            valid = ctx.lane_valid
            p, c, z, n, rel = (t[valid].cpu().numpy()
                               for t in (p, c, z, n, ctx.rel))
            end = (rel + 1) * C.SUBSEQ_SIZE_BITS
            bad = []
            if not ((p >= 0) & (p <= end)).all():
                bad.append("bit position outside subsequence window")
            if not ((c >= 0) & (c < cfg.du_per_mcu)).all():
                bad.append("component counter outside MCU")
            if not ((z >= 0) & (z < 64)).all():
                bad.append("zig-zag index outside data unit")
            if not (n >= 0).all():
                bad.append("negative symbol count")
            if bad:
                raise InternalError(
                    f"sync-state invariants violated (scan {si}): "
                    + "; ".join(bad))
        self._log("debug: sync-state numeric invariants hold")

    def decode_rgb(self) -> np.ndarray:
        """Convenience: decode + chroma upsample + YCbCr->RGB (host side,
        mirroring example/example_tool.c + util/util.h)."""
        planes = self.decode()
        stream = self._require_plan().stream
        sampling = [(c.ss_x, c.ss_y) for c in stream.components]
        return to_rgb(planes, sampling)

    # -- phase 5: cleanup (jpeggpu.h:57-58) --
    def cleanup(self) -> None:
        self._plan = None
        self._data = None
        self._staged = None
        self._device_inputs = None
        self._staging.release()

    def __enter__(self) -> "Decoder":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()


def is_css_444(subsampling: Sequence[Tuple[int, int]],
               num_components: int) -> bool:
    """True iff every component is 1x1 sampled (reference is_css_444,
    jpeggpu.h:70-71)."""
    return all(subsampling[c] == (1, 1) for c in range(num_components))


def decode(data: bytes, *, device=None) -> List[np.ndarray]:
    """One-shot decode to planar components."""
    with Decoder(device=device) as d:
        d.parse_header(data)
        return d.decode()


def decode_rgb(data: bytes, *, device=None) -> np.ndarray:
    """One-shot decode to interleaved RGB."""
    with Decoder(device=device) as d:
        d.parse_header(data)
        return d.decode_rgb()
