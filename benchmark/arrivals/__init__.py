"""How requests arrive in the measured window: one module per ``arrivals``
named in a traffic mix (``closed`` where the mix names none).

Each module defines ``drive(window)``: it takes requests from
``window.stream``, has ``window.loop`` serve them until
``window.deadline``, reports each through :meth:`Window.answered` or
:meth:`Window.refused`, and returns the time the last answer came. It
reads its own parameters from ``window.params`` (the cell's), so that an
arrival process of another shape (an open loop at a rate, several clients)
is a module of its own and a mix that names it.
"""

from __future__ import annotations

import dataclasses
import sys
import traceback
from typing import Dict


@dataclasses.dataclass
class Window:
    stream: object  # traffic.Stream: next() -> traffic.Request
    loop: object  # loops.<name>.Loop: serve(datas, rec) -> planes per image
    rec: object  # records.Records
    sample: object  # check.Sample
    deadline: float  # time.perf_counter() at which no request is sent
    params: Dict
    attempted: int = 0
    failed: int = 0

    def answered(self, req, outs, sent: float, done: float) -> None:
        """`req`, sent at `sent`, answered with `outs` at `done`."""
        self.attempted += len(req.datas)
        self.rec.latencies.append(done - sent)
        self.rec.images += len(req.datas)
        self.rec.pixels += req.pixels
        for key, planes in zip(req.keys, outs):
            self.sample.offer(key, planes)

    def refused(self, req) -> None:
        """`req` raised: counted as failed, with its traceback logged."""
        print(traceback.format_exc(), file=sys.stderr, flush=True)
        self.attempted += len(req.datas)
        self.failed += len(req.datas)


def load(name: str):
    """``drive`` of ``arrivals/<name>.py``."""
    import importlib

    return importlib.import_module(f"{__name__}.{name}").drive
