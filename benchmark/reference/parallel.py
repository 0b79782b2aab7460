"""The reference's decodes spread over worker processes.

A JPEG whose restart interval is one MCU row is cut into strips of whole
rows, each a JPEG of its own (:meth:`.rows.Rows.strip`): its restart
segments are independent, so the strips' planes, stacked, are the
image's. Other JPEGs decode whole. Workers are spawned (they import numpy
and this package only) and all of them have ended when :func:`decode_all`
returns.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
from typing import Callable, List, Sequence, Tuple

import numpy as np

from .golden import decode
from .rows import Rows


def strips(data: bytes, n: int) -> List[bytes]:
    """`data` as up to `n` JPEGs of consecutive MCU rows; `data` itself
    where its restart interval is not one MCU row."""
    rows = Rows.cut(data) if n > 1 else None
    if rows is None or rows.rows < 2:
        return [data]
    per = -(-rows.rows // min(n, rows.rows))
    return [rows.strip(a, min(a + per, rows.rows))
            for a in range(0, rows.rows, per)]


def decode_all(datas: Sequence[bytes], workers: int = 1,
               decoder: Callable[[bytes], List[np.ndarray]] = decode
               ) -> List[List[np.ndarray]]:
    """The planes of each of `datas` by `decoder` (the reference's, or
    another function of a module, which the workers import), decoded by
    `workers` processes (in this one for 1)."""
    tasks: List[bytes] = []
    spans: List[Tuple[int, int]] = []
    for data in datas:
        parts = strips(data, max(1, workers // max(1, len(datas))))
        spans.append((len(tasks), len(tasks) + len(parts)))
        tasks += parts
    if workers <= 1 or len(tasks) == 1:
        done = [decoder(t) for t in tasks]
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                min(workers, len(tasks)), mp_context=ctx) as pool:
            done = list(pool.map(decoder, tasks))
    return [[np.concatenate(ps, axis=0) for ps in zip(*done[a:b])]
            for a, b in spans]
