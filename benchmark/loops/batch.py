"""A request's images as one call of the port's ``BatchDecoder``
(``decode``: parse, group by geometry, merged decodes, the per-image
route, planes copied to numpy). One ``BatchDecoder`` serves the whole run.

Span: ``batch`` (seconds per call). Record: the call's ``routes``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from jpeggpu_tpu_torch.parallel.batch import BatchDecoder


class Loop:
    def __init__(self, device: torch.device, ranges: bool = False):
        self.device = device
        self.decoder = BatchDecoder(device=device)
        self.ranges = ranges

    def serve(self, datas, rec):
        t0 = time.perf_counter()
        with (torch.profiler.record_function("bench.batch") if self.ranges
              else contextlib.nullcontext()):
            out = self.decoder.decode(list(datas))
        rec.span("batch", time.perf_counter() - t0)
        rec.routes.append((len(datas), list(self.decoder.routes)))
        return out
