"""The least bytes a kernel moves for one image, counted from the frozen
reader's parse of the JPEG the program was handed (not from the port's
plan): each input byte read once, each output byte written once.

- K2, the writing decode (``decode_write.cu``): reads the scan's entropy-
  coded bytes, writes the coefficient stream (data units x 64 x int16).
- K3, the tail (``idct_stream.cu``): reads the coefficient stream, writes
  the component planes (uint8, each component's width x height).
"""

from __future__ import annotations

from typing import Dict, Sequence

from .reference.constants import DATA_UNIT_SIZE
from .reference.reader import parse


def counts(data: bytes) -> Dict[str, int]:
    stream = parse(data)
    return dict(
        entropy=sum(s.end - s.begin for s in stream.scans),
        coeff=sum(s.total_data_units for s in stream.scans)
        * DATA_UNIT_SIZE * 2,
        planes=sum(c.size_x * c.size_y for c in stream.components))


def total(datas: Sequence[bytes], *keys: str) -> int:
    """The sum over `datas` of the counts named by `keys`."""
    out = 0
    for data in datas:
        c = counts(data)
        out += sum(c[k] for k in keys)
    return out


def share(rec, kernel: str, *keys: str):
    """The least time to move `keys`' bytes of the traced images at the
    card's HBM bandwidth, over the time of `kernel`'s launches, in %; None
    where the window has no such launch or the card no entry."""
    bw = rec.peak("hbm_bytes_per_s")
    if rec.trace is None or bw is None:
        return None
    t = rec.kernel_s(kernel)
    if t <= 0:
        return None
    return total(rec.traced_inputs, *keys) / bw / t * 100.0
