"""The general traffic generator: a traffic mix's parameters -> requests.

A cell's parameters are its configuration's file with its traffic mix's
file laid over it (a key of the mix wins). The generator reads:

- ``pool``: how many distinct images the run makes (:func:`inputs.make_pool`);
- ``order``: ``"cycle"`` sends the pool's images in turn; ``"epochs"`` sends
  each pass over the pool in a new order drawn from the seed;
- ``batch``: images per request;
- ``arrivals``: the module of ``arrivals/`` that sends the requests in the
  window (``closed``, one client, where the mix names none);
- ``permute_rows``: every image of a request is its pool image with its
  MCU rows in a new order drawn from the seed (:mod:`.reference.rows`), so
  that no two requests carry the same bytes.

A request carries, per image, a key (pool index, row order or None) from
which the reference rebuilds what the image must decode to.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .inputs import PoolImage, seed_key
from .reference.rows import Rows

Key = Tuple[int, Optional[Tuple[int, ...]]]


@dataclasses.dataclass
class Request:
    datas: List[bytes]
    keys: List[Key]
    pixels: int  # luma width x height of its images


class Stream:
    """The requests of one run, drawn from the seed: stream `sub` of the
    seed (the window and the warm-up draw from different streams)."""

    def __init__(self, pool: List[PoolImage], params: Dict, seed: int,
                 sub: int, rows: Optional[List[Rows]] = None):
        self.pool = pool
        self.order = params.get("order", "cycle")
        if self.order not in ("cycle", "epochs"):
            raise ValueError(f"unknown order {self.order!r}")
        self.batch = int(params.get("batch", 1))
        self.rows = rows if params.get("permute_rows") else None
        self.rng = np.random.default_rng(seed_key(seed, 2, sub))
        self._queue: deque = deque()
        self._next = 0

    def _index(self) -> int:
        if self.order == "cycle":
            i = self._next % len(self.pool)
            self._next += 1
            return i
        if not self._queue:
            self._queue.extend(int(i) for i in
                               self.rng.permutation(len(self.pool)))
        return self._queue.popleft()

    def next(self) -> Request:
        datas, keys, pixels = [], [], 0
        for _ in range(self.batch):
            i = self._index()
            im = self.pool[i]
            perm = None
            if self.rows is not None:
                perm = tuple(int(r) for r in
                             self.rng.permutation(self.rows[i].rows))
                datas.append(self.rows[i].permuted(perm))
            else:
                datas.append(im.data)
            keys.append((i, perm))
            pixels += im.width * im.height
        return Request(datas, keys, pixels)


def row_cuts(pool: List[PoolImage], params: Dict) -> Optional[List[Rows]]:
    """The pool's images cut into rows, where the mix permutes them."""
    if not params.get("permute_rows"):
        return None
    return [Rows(im.data) for im in pool]
