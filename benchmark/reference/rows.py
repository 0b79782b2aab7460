"""A JPEG whose restart interval is one MCU row, cut into its rows.

Each row is a restart segment of its own (the DC predictors reset at every
marker), so any sequence of rows joined under the image's header, RSTn
renumbered in order and the frame's height patched, is a JPEG of its own
(:meth:`Rows.join`). Two uses: the rows of a request in another order
(:meth:`Rows.permuted`, with :meth:`Rows.permute_planes` moving decoded
planes alike), and the strips that the reference decodes in parallel
(:meth:`Rows.strip`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import constants as C
from .reader import parse


def _sof_height(head: bytearray, height: int) -> None:
    pos = 2
    while head[pos + 1] != C.MARKER_SOF0:
        pos += 2 + int.from_bytes(head[pos + 2:pos + 4], "big")
    head[pos + 5:pos + 7] = height.to_bytes(2, "big")


class Rows:
    """The restart segments of a single-scan JPEG with a marker on every
    MCU row; :meth:`cut` gives None for any other JPEG."""

    def __init__(self, data: bytes):
        stream = parse(data)
        if len(stream.scans) != 1:
            raise ValueError("rows need a single-scan JPEG")
        scan, = stream.scans
        if stream.restart_interval != scan.num_mcus_x:
            raise ValueError("rows need a restart marker on every MCU row")
        self.mcu_h = 8 * stream.ss_max_y
        self.height = stream.size_y
        self.head = data[:scan.begin]
        body = data[scan.begin:scan.end]
        self.segs = [body[a:b] for a, b in scan.seg_raw]
        self.rows = len(self.segs)
        self.comp_rows = [8 * (c.ss_y if scan.interleaved else 1)
                          for c in stream.components]

    @classmethod
    def cut(cls, data: bytes) -> Optional["Rows"]:
        try:
            return cls(data)
        except ValueError:
            return None

    def join(self, order: Sequence[int], height: Optional[int] = None
             ) -> bytes:
        """The JPEG of rows `order`, in that order, RSTn renumbered; its
        frame `height` pixels high where given."""
        head = self.head
        if height is not None:
            head = bytearray(head)
            _sof_height(head, height)
        parts = [bytes(head)]
        for r, p in enumerate(order):
            if r:
                parts.append(bytes((0xFF, C.MARKER_RST0 + ((r - 1) & 7))))
            parts.append(self.segs[p])
        parts.append(bytes((0xFF, C.MARKER_EOI)))
        return b"".join(parts)

    def strip(self, a: int, b: int) -> bytes:
        """Rows a to b (exclusive) as a JPEG of their own."""
        return self.join(range(a, b),
                         min(b * self.mcu_h, self.height) - a * self.mcu_h)

    def _whole(self) -> None:
        if self.height % self.mcu_h:
            raise ValueError("row order needs whole MCU rows")

    def permuted(self, perm: Sequence[int]) -> bytes:
        """The JPEG whose MCU row r is this one's row ``perm[r]``."""
        self._whole()
        return self.join(perm)

    def permute_planes(self, planes: Sequence[np.ndarray],
                       perm: Optional[Sequence[int]]) -> List[np.ndarray]:
        """This image's planes with their MCU rows in the order of
        :meth:`permuted`'s."""
        if perm is None:
            return list(planes)
        self._whole()
        out = []
        for p, k in zip(planes, self.comp_rows):
            rows = p.reshape(self.rows, k, p.shape[1])
            out.append(rows[np.asarray(perm)].reshape(p.shape))
        return out
