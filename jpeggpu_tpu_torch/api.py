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
                                 scan words, tables, segment arrays)
  _decode                        Decoder.decode(with_idct=True, device=False,
                                 donate=False) -> planes
  _cleanup                       Decoder.cleanup() / context manager

``device=None`` is the CUDA device and raises where there is none; pass
``device="cpu"`` to run the kernels' plain versions (as the tests do).
The other keywords are the JAX package's, with its meanings; what the port
cannot do yet (``host_destuff=False``, ``donate=True``) raises
``NotSupported``.

The plan that ``parse_header`` builds carries the process default tuning
(``config.set_default_tuning``): that is how a ``Decoder`` or ``decode`` is
sent through the records write path (``Tuning(write_mode="tiles")``); the
entry points take no tuning argument.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .errors import InvalidArgument, NotSupported
from .pipeline import (
    DecodePlan,
    build_inputs,
    build_plan,
    decode_pipeline,
    plan_buffer_size,
    resolve_device,
    stage_inputs,
)
from .reader import parse
from .utils.color import to_rgb


@dataclasses.dataclass
class ImgInfo:
    """Mirror of jpeggpu_img_info (jpeggpu.h:73-80)."""

    sizes_x: List[int]
    sizes_y: List[int]
    num_components: int
    subsampling: List[Tuple[int, int]]


class Decoder:
    """Reusable decoder handle (analog of jpeggpu_decoder_t)."""

    def __init__(self, *, device=None, host_destuff: bool = True):
        if not host_destuff:
            raise NotSupported("host_destuff=False (the device destuff) is "
                               "not ported yet")
        self._device = resolve_device(device)
        self._logging = False
        self._plan: Optional[DecodePlan] = None
        self._data: Optional[bytes] = None
        self._staged = None
        self._device_inputs = None

    # -- phase 0: logging toggle (jpeggpu.h:61-62) --
    def set_logging(self, enabled: bool) -> None:
        self._logging = bool(enabled)

    def _log(self, msg: str) -> None:
        if self._logging:
            print(msg, flush=True)

    # -- phase 1: host-only header parse (jpeggpu.h:81-85) --
    def parse_header(self, data: bytes) -> ImgInfo:
        stream = parse(data, log=self._log if self._logging else None)
        self._plan = build_plan(stream)
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
            self._staged = build_inputs(self._data, self._require_plan())
        return self._staged

    # -- phase 3: host->device staging (jpeggpu.h:90-93) --
    def transfer(self) -> None:
        self._device_inputs = stage_inputs(
            self._host_inputs(), self._require_plan(), self._device)

    # -- phase 4: decode (jpeggpu.h:102-109) --
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
        materialises numpy arrays (one blocking copy).

        ``donate=True`` (the staged inputs consumed by the decode) is the
        JAX package's keyword and raises ``NotSupported`` until it is
        ported.
        """
        plan = self._require_plan()
        if donate:
            raise NotSupported("decode(donate=True) is not ported yet")
        if self._device_inputs is None:
            self.transfer()
        for s, scan in enumerate(plan.stream.scans):
            self._log(f"scan {s}: {scan.num_subsequences} subsequences in "
                      f"{scan.num_segments} segment(s), "
                      f"{scan.num_mcus_x}x{scan.num_mcus_y} MCUs")
        dev = self._device_inputs
        out = decode_pipeline(plan.signature, dev["scans"], dev["qtables"],
                              with_idct)
        if device:
            return list(out)
        return [p.contiguous().cpu().numpy() for p in out]

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
