"""Golden CPU decoder: the bit-exact sequential oracle.

An independent, readably-sequential implementation of the exact integer
pipeline the device kernels implement. Used by the test-suite to check the
device pipeline bit-for-bit (the reference project only had a "near-equal"
nvJPEG oracle, test/test.cpp:299-314 — we hold ourselves to exact equality).

Decode semantics intentionally identical to the device path, including its
handling of zero-padded segment tails (cf. decode_huffman.cu:302-394):

- a symbol whose bits would cross the end of the segment's subsequence-padded
  data is never committed,
- output positions are bounded per segment by
  ``min((seg+1)*mcus_per_segment, total_mcus) * du_per_mcu * 64``,
- only nonzero coefficients are written (buffer is zero-initialized).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import constants as C
from .idct_int import dequant_idct_blocks
from .reader import JpegStream, Scan, num_mcus_in_segment, parse
from .tables import HuffmanTable, decode_category_scalar


def destuff_scan_host(buf: np.ndarray, scan: Scan) -> np.ndarray:
    """Destuff a scan into the device layout.

    Returns a uint8 array of ``num_subsequences * 128`` bytes where segment
    ``s`` occupies ``[segments[s,0]*128, +segments[s,1]*128)``, zero padded —
    the same layout the device destuff stage produces
    (decode_destuff.cu:75-113).
    """
    body = buf[scan.begin:scan.end]
    n = len(body)
    out = np.zeros(scan.num_subsequences * C.SUBSEQ_SIZE_BYTES, np.uint8)
    if n == 0:
        return out
    prev_is_ff = np.concatenate(([False], body[:-1] == 0xFF))
    is_data = (prev_is_ff & (body == 0)) | (~prev_is_ff & (body != 0xFF))
    # the 0x00 of a 0xFF00 pair is rewritten as the literal 0xFF
    byte_write = np.where(prev_is_ff, np.uint8(0xFF), body)
    is_rst_2nd = prev_is_ff & (body >= C.MARKER_RST0) & (body <= C.MARKER_RST7)
    seg_id = np.cumsum(is_rst_2nd)  # segment index per byte
    data_cum = np.cumsum(is_data)  # data bytes in [0..i] inclusive
    seg_starts = np.flatnonzero(np.diff(np.concatenate(([0], seg_id))) > 0)
    # data bytes before the start of each segment
    data_before_seg = np.concatenate(([0], data_cum[seg_starts - 1]))
    idx_in_seg = data_cum - 1 - data_before_seg[seg_id]
    seg_offsets = scan.segments[:, 0].astype(np.int64)
    dst = seg_offsets[seg_id] * C.SUBSEQ_SIZE_BYTES + idx_in_seg
    out[dst[is_data]] = byte_write[is_data]
    return out


class _BitReader:
    """MSB-first reader over a byte buffer, zero-padded past the end."""

    __slots__ = ("data", "nbits", "p")

    def __init__(self, data: np.ndarray):
        self.data = data.tobytes() + b"\x00" * 8
        self.nbits = len(data) * 8
        self.p = 0

    def peek32(self) -> int:
        b = self.p >> 3
        chunk = int.from_bytes(self.data[b:b + 8], "big")
        return (chunk >> (32 - (self.p & 7))) & 0xFFFFFFFF


def _extract_value(bits32: int, cat_len: int, cat: int) -> int:
    """Read ``cat`` value bits following the category code and sign-extend
    (T.81 F.12 EXTEND, decode_huffman.cu:196-200).

    Shift amounts are guarded identically to the device path so garbage
    categories (only reachable from invalid streams) stay deterministic and
    device/golden-consistent.
    """
    offset = ((bits32 << cat_len) & 0xFFFFFFFF) >> ((32 - cat) & 31)
    cat_c = min(cat, 31)
    if offset < (1 << cat_c) >> 1:
        return offset - (1 << cat_c) + 1
    return offset


# category decode: the 8-bit-prefix LUT fast path with maxcode fallback
# (tables.decode_category_scalar) — shared with the reader-side tooling
_decode_category = decode_category_scalar


def decode_scan_coefficients(stream: JpegStream, scan: Scan, buf: np.ndarray) -> np.ndarray:
    """Entropy-decode one scan into stream-order coefficients.

    Returns int16[total_data_units * 64]; within each data unit the values
    are in natural (raster) order, DC still difference-coded.
    """
    destuffed = destuff_scan_host(buf, scan)
    du_per_mcu = scan.num_data_units_in_mcu
    mcus_per_seg = num_mcus_in_segment(stream, scan)
    total_positions = scan.total_data_units * C.DATA_UNIT_SIZE
    out = np.zeros(total_positions, np.int16)

    # per-MCU-slot DC/AC table ids
    dc_tbl: List[HuffmanTable] = []
    ac_tbl: List[HuffmanTable] = []
    for sc in scan.components:
        t_dc = scan.huff_tables[sc.dc_table_id * C.HUFF_COUNT + C.HUFF_DC]
        t_ac = scan.huff_tables[sc.ac_table_id * C.HUFF_COUNT + C.HUFF_AC]
        for _ in range(sc.du_per_mcu):
            dc_tbl.append(t_dc)
            ac_tbl.append(t_ac)

    natural = C.ORDER_NATURAL
    for s in range(scan.num_segments):
        subseq_off, subseq_cnt = int(scan.segments[s, 0]), int(scan.segments[s, 1])
        seg_bytes = destuffed[
            subseq_off * C.SUBSEQ_SIZE_BYTES:(subseq_off + subseq_cnt) * C.SUBSEQ_SIZE_BYTES]
        reader = _BitReader(seg_bytes)
        seg_bits = subseq_cnt * C.SUBSEQ_SIZE_BITS
        pos = s * mcus_per_seg * du_per_mcu * C.DATA_UNIT_SIZE
        bound = min((s + 1) * mcus_per_seg * du_per_mcu * C.DATA_UNIT_SIZE, total_positions)
        c = 0
        z = 0
        while pos < bound:
            bits32 = reader.peek32()
            if z == 0:
                cat, cat_len = _decode_category(dc_tbl[c], bits32)
                run = 0
                if cat == 0:
                    sym, length = 0, cat_len
                else:
                    sym = _extract_value(bits32, cat_len, cat)
                    length = cat_len + cat
            else:
                v, cat_len = _decode_category(ac_tbl[c], bits32)
                run, cat = v >> 4, v & 0xF
                if cat == 0:
                    sym, length = 0, cat_len
                    run = 15 if run == 15 else 63 - z
                else:
                    sym = _extract_value(bits32, cat_len, cat)
                    length = cat_len + cat
            if reader.p + length > seg_bits:
                break  # symbol would cross the padded segment end
            reader.p += length
            pos += run
            # writes are clamped to the segment's own position range so a
            # corrupt segment's final run cannot overrun into the next
            # segment (mirrored by the device decoder's per-lane bound)
            if sym != 0 and pos < bound:
                du, idx = divmod(pos, C.DATA_UNIT_SIZE)
                out[du * C.DATA_UNIT_SIZE + natural[idx]] = sym
            pos += 1
            z += run + 1
            if z >= 64:
                z = 0
                c += 1
                if c >= du_per_mcu:
                    c = 0
    return out


def sequential_boundary_states(stream: JpegStream, scan: Scan,
                               buf: np.ndarray) -> np.ndarray:
    """Decoder state at every subsequence boundary, computed sequentially.

    Returns int32[num_subsequences, 4] rows ``(p, c, z, n)`` exactly matching
    the device decoder's converged ``sync_states`` output: ``p`` is the
    segment-relative bit position after the last symbol that fits inside
    subsequence ``i`` (a symbol crossing the 1024-bit boundary belongs to the
    next subsequence), ``c``/``z`` the data-unit slot and zig-zag index there,
    ``n`` the coefficient positions (sum of run+1) produced by subsequence
    ``i``. Like the device sync pass — and unlike
    :func:`decode_scan_coefficients` — this decodes by *bits alone*, running
    through the zero padding at each segment tail, because the speculative
    lanes have no position bound while synchronizing.
    """
    destuffed = destuff_scan_host(buf, scan)
    du_per_mcu = scan.num_data_units_in_mcu
    dc_tbl: List[HuffmanTable] = []
    ac_tbl: List[HuffmanTable] = []
    for sc in scan.components:
        t_dc = scan.huff_tables[sc.dc_table_id * C.HUFF_COUNT + C.HUFF_DC]
        t_ac = scan.huff_tables[sc.ac_table_id * C.HUFF_COUNT + C.HUFF_AC]
        for _ in range(sc.du_per_mcu):
            dc_tbl.append(t_dc)
            ac_tbl.append(t_ac)

    out = np.zeros((scan.num_subsequences, 4), np.int32)
    for s in range(scan.num_segments):
        subseq_off, subseq_cnt = int(scan.segments[s, 0]), int(scan.segments[s, 1])
        seg_bytes = destuffed[
            subseq_off * C.SUBSEQ_SIZE_BYTES:
            (subseq_off + subseq_cnt) * C.SUBSEQ_SIZE_BYTES]
        reader = _BitReader(seg_bytes)
        c = z = n_cur = 0
        k = 0  # subsequence (rel) index currently being decoded
        while k < subseq_cnt:
            bits32 = reader.peek32()
            if z == 0:
                cat, cat_len = _decode_category(dc_tbl[c], bits32)
                run = 0
                length = cat_len + (cat if cat else 0)
            else:
                v, cat_len = _decode_category(ac_tbl[c], bits32)
                run, cat = v >> 4, v & 0xF
                if cat == 0:
                    run = 15 if run == 15 else 63 - z
                length = cat_len + cat
            # hand off at every boundary the next symbol would cross
            while k < subseq_cnt and reader.p + length > (k + 1) * C.SUBSEQ_SIZE_BITS:
                out[subseq_off + k] = (reader.p, c, z, n_cur)
                n_cur = 0
                k += 1
            if k >= subseq_cnt:
                break
            reader.p += length
            n_cur += run + 1
            z += run + 1
            if z >= 64:
                z = 0
                c += 1
                if c >= du_per_mcu:
                    c = 0
    return out


def undelta_dc(stream: JpegStream, scan: Scan, coeffs: np.ndarray) -> None:
    """Undo DC difference coding in-place (stream order), per component and
    per restart segment (decode_dc.cu:88-169)."""
    du_per_mcu = scan.num_data_units_in_mcu
    mcus_per_seg = num_mcus_in_segment(stream, scan)
    total_du = scan.total_data_units
    d = np.arange(total_du)
    mcu_of = d // du_per_mcu
    slot_of = d % du_per_mcu
    seg_of = mcu_of // mcus_per_seg
    for sc in scan.components:
        sel = (slot_of >= sc.off_in_mcu) & (slot_of < sc.off_in_mcu + sc.du_per_mcu)
        idx = d[sel]
        dc = coeffs[idx * C.DATA_UNIT_SIZE].astype(np.int64)
        segs = seg_of[sel]
        cum = np.cumsum(dc)
        starts = np.flatnonzero(np.diff(np.concatenate(([-1], segs))) > 0)
        base = np.zeros(len(dc), np.int64)
        if len(starts) > 1:
            inc = np.diff(np.concatenate(([0], cum[starts[1:] - 1])))
            base[starts[1:]] = inc
            base = np.cumsum(base)
        coeffs[idx * C.DATA_UNIT_SIZE] = (cum - base).astype(np.int16)


def deinterleave(scan: Scan, coeffs: np.ndarray, stream: JpegStream) -> Dict[int, np.ndarray]:
    """Stream-order coefficients -> per-component planar rasters
    (decode_transpose.cu:41-132)."""
    du_per_mcu = scan.num_data_units_in_mcu
    num_mcus = scan.num_mcus
    arr = coeffs.reshape(num_mcus, du_per_mcu, C.DATA_UNIT_SIZE)
    planes: Dict[int, np.ndarray] = {}
    for sc in scan.components:
        comp = stream.components[sc.component_idx]
        ssx = comp.ss_x if scan.interleaved else 1
        ssy = comp.ss_y if scan.interleaved else 1
        part = arr[:, sc.off_in_mcu:sc.off_in_mcu + sc.du_per_mcu, :]
        part = part.reshape(scan.num_mcus_y, scan.num_mcus_x, ssy, ssx, 8, 8)
        plane = part.transpose(0, 2, 4, 1, 3, 5).reshape(
            sc.data_size_y, sc.data_size_x)
        planes[sc.component_idx] = plane
    return planes


def decode(data: bytes, *, with_idct: bool = True) -> List[np.ndarray]:
    """Decode a baseline JPEG fully on CPU.

    Returns per-component planes: uint8 (cropped to component size) when
    ``with_idct``, else int16 dequantizable coefficient planes (padded to
    MCU multiples).
    """
    buf = np.frombuffer(data, np.uint8)
    stream = parse(data)
    planes: Dict[int, np.ndarray] = {}
    for scan in stream.scans:
        coeffs = decode_scan_coefficients(stream, scan, buf)
        undelta_dc(stream, scan, coeffs)
        planes.update(deinterleave(scan, coeffs, stream))
    out: List[np.ndarray] = []
    for ci in range(stream.num_components):
        comp = stream.components[ci]
        plane = planes[ci]
        if not with_idct:
            out.append(plane)
            continue
        h, w = plane.shape
        blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
        blocks = blocks.astype(np.int32).reshape(-1, 8, 8)
        q = stream.qtables[comp.qtable_idx].astype(np.int32)
        pix = dequant_idct_blocks(np, blocks, q)
        pix = pix.reshape(h // 8, w // 8, 8, 8).transpose(0, 2, 1, 3).reshape(h, w)
        out.append(pix[:comp.size_y, :comp.size_x].astype(np.uint8))
    return out
