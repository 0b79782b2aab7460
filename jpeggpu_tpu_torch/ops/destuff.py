"""Device destuffing: remove 0xFF00 stuffing and restart markers, compact
each restart segment into subsequence-aligned (128-byte, zero padded) form.

The port of ``jpeggpu_tpu/ops/destuff.py``, which is XLA tensor code and no
Pallas kernel; its counterpart here is tensor code too, on whatever device
holds the bytes: per-byte classification and prefix sums, the data base of
each segment as a running maximum, and one scatter whose destinations
increase, with the bytes that are not data sent to one slot past the end.
No step compacts with a boolean mask, which would make the host wait for
the device.

The running maximum is taken in two levels (:func:`_segment_base`):
``torch.cummax`` of a single long row runs in one thread block on the card
(6.2 ms for the 2.5 MB scan of a 12 MP image at quality 90, NVIDIA H100),
while rows of 1024 run side by side.
"""

from __future__ import annotations

import torch

from .. import constants as C

_ROW = 1024  # row length of the two-level running maximum


def _segment_base(data_cum: torch.Tensor,
                  is_rst: torch.Tensor) -> torch.Tensor:
    """Per byte, ``data_cum`` at the most recent restart marker's second
    byte (0 before the first): since ``data_cum`` never falls, the running
    maximum of ``data_cum * is_rst``, ``torch.cummax(...).values``. Taken
    within rows of ``_ROW``, then each row raised to the maximum of the
    rows before it."""
    n = data_cum.numel()
    x = data_cum * is_rst
    if n % _ROW:
        x = torch.nn.functional.pad(x, (0, -n % _ROW))
    rows = torch.cummax(x.view(-1, _ROW), 1).values
    del x
    carry = torch.cummax(rows[:, -1], 0).values
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    return torch.maximum(rows, carry[:, None]).view(-1)[:n]


def destuff_scan(scan_bytes: torch.Tensor, seg_sub_offset: torch.Tensor,
                 num_subseq_padded: int) -> torch.Tensor:
    """Destuff one scan's raw entropy bytes into decode layout.

    Args:
      scan_bytes: uint8[n] raw (stuffed) scan body, zero padded.
      seg_sub_offset: int32[num_segments_padded] first subsequence of each
        segment (host-parsed; padded entries hold the subsequence count).
      num_subseq_padded: padded subsequence count (lanes).

    Returns:
      int32[num_subseq_padded * 32], the bit patterns of the big-endian
      words of the destuffed data (the layout of ``ScanArrays.words``):
      segment s occupies words [seg_sub_offset[s] * 32, ...), zero padded.
    """
    b = scan_bytes
    total = num_subseq_padded * C.SUBSEQ_SIZE_BYTES
    prev_ff = torch.zeros_like(b, dtype=torch.bool)
    prev_ff[1:] = b[:-1] == 0xFF
    # data: any byte but 0xFF, and the 0x00 of a stuffed 0xFF00, which is
    # written as 0xFF
    is_data = torch.where(prev_ff, b == 0, b != 0xFF)
    byte_write = b.masked_fill(prev_ff, 0xFF)
    is_rst = prev_ff & (b >= C.MARKER_RST0) & (b <= C.MARKER_RST7)
    del prev_ff
    data_cum = torch.cumsum(is_data, 0, dtype=torch.int32)  # inclusive
    # data bytes before the current segment: data_cum at the most recent
    # restart marker's second byte (no data there, so it counts the bytes
    # before it)
    seg_base = _segment_base(data_cum, is_rst)
    seg_id = torch.cumsum(is_rst, 0, dtype=torch.int32)
    del is_rst
    nseg = seg_sub_offset.numel()
    sub_off = seg_sub_offset.index_select(0, seg_id.clamp_(0, nseg - 1))
    del seg_id
    dst = data_cum.sub_(1).sub_(seg_base).add_(
        sub_off.mul_(C.SUBSEQ_SIZE_BYTES))
    del sub_off, data_cum, seg_base
    # byte k of a word goes to byte 3 - k, so that the little-endian int32
    # view of the buffer holds each big-endian word; total is a multiple of
    # 4, so dst < total exactly when dst ^ 3 < total
    dst = torch.where(is_data & (dst < total), dst ^ 3, total)
    out = torch.zeros(total + 1, dtype=torch.uint8, device=b.device)
    out.index_put_((dst.long(),), byte_write)
    return out[:total].view(torch.int32)
