"""One image at a time through the port's five-phase ``Decoder``:
``parse_header``, ``transfer``, ``decode(device=True)``, then a
synchronisation, so the planes are ready on the card. One ``Decoder`` serves
the whole run.

Spans: ``parse_header``, ``transfer``, ``decode`` (seconds per image).
Counter: ``sync_rounds``, the launches of the sync round (K1,
``ops.huffman.subseq_pass.launches``) during each image's decode.
"""

from __future__ import annotations

import contextlib
import time

import torch

from jpeggpu_tpu_torch.api import Decoder
from jpeggpu_tpu_torch.ops import huffman


class Loop:
    def __init__(self, device: torch.device, ranges: bool = False):
        self.device = device
        self.decoder = Decoder(device=device)
        self.ranges = ranges

    def _range(self, name: str):
        if self.ranges:
            return torch.profiler.record_function(f"bench.{name}")
        return contextlib.nullcontext()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, datas, rec):
        out = []
        d = self.decoder
        for data in datas:
            t0 = time.perf_counter()
            with self._range("parse_header"):
                d.parse_header(data)
            t1 = time.perf_counter()
            with self._range("transfer"):
                d.transfer()
            t2 = time.perf_counter()
            k1 = huffman.subseq_pass.launches
            with self._range("decode"):
                planes = d.decode(device=True)
                self._sync()
            t3 = time.perf_counter()
            rec.span("parse_header", t1 - t0)
            rec.span("transfer", t2 - t1)
            rec.span("decode", t3 - t2)
            rec.count("sync_rounds", huffman.subseq_pass.launches - k1)
            out.append(planes)
        return out
