"""Host-side bitstream reader: marker parse, table derivation, segment discovery.

This is the analog of the reference host parser (src/reader.cpp:596-672 and
the jpeg_stream model of src/reader.hpp:38-131): it runs once per image on
CPU, touches every byte at most a constant number of times, and produces a
:class:`JpegStream` describing everything the device pipeline needs with
*static* geometry.

All of a stream's header work is one call into the native host library
(``native/header.cpp``): markers, frame, tables (the Huffman tables derived
into their decode arrays there), scans and each scan body's segment walk
(``native/walk.cpp``, one memchr pass, as reader.cpp:443-489). Python wraps
its output into the stream; each Huffman table is wrapped once, its arrays
read-only, and scans that hold the same definition share it. The Python
parser (:func:`_parse_python`, same checks, same results, same errors)
runs where the machine has no C++ compiler, or where a scan body holds more
restart segments than its header allows; it walks a body natively where it
can, else with the numpy walk (:func:`_numpy_walk`). Counters, read by tests
and ``chip_smoke.py``: ``parses``, the streams each parser took, and
``walks``, the scans each walk took (a scan of the native pass counts as
``"native"``).

Known deliberate divergence from the reference: for non-interleaved scans of
a subsampled component the reference keeps ``num_data_units_in_mcu`` as the
sum of the component sampling factors (reader.cpp:421) which mis-keys its DC
prefix-sum and transpose for such scans; per T.81 A.2.2 the MCU of a
non-interleaved scan is a single data unit, which is what we implement.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from . import constants as C
from . import native
from .errors import IncompleteBitstream, InvalidJpeg, NotSupported
from .tables import HuffmanTable, build_huffman_table

parses = {"native": 0, "python": 0}
walks = {"native": 0, "numpy": 0}


@dataclasses.dataclass
class Component:
    """Logical frame component (SOF)."""

    id: int = 0
    qtable_idx: int = 0
    # component plane size after subsampling (T.81 A.1.1)
    size_x: int = 0
    size_y: int = 0
    # sampling factors from SOF
    ss_x: int = 1
    ss_y: int = 1


@dataclasses.dataclass
class ScanComponent:
    component_idx: int
    dc_table_id: int  # 0..3, global DHT slot
    ac_table_id: int  # 0..3
    mcu_size_x: int = 0
    mcu_size_y: int = 0
    # plane size padded up to whole MCUs for this scan
    data_size_x: int = 0
    data_size_y: int = 0
    # first data-unit slot of this component inside an interleaved MCU
    off_in_mcu: int = 0
    # data units of this component per MCU (ss_x*ss_y if interleaved else 1)
    du_per_mcu: int = 1


@dataclasses.dataclass
class Scan:
    components: List[ScanComponent] = dataclasses.field(default_factory=list)
    begin: int = 0  # byte offset of first entropy byte
    end: int = 0  # byte offset one past last entropy byte
    num_data_units_in_mcu: int = 1
    num_mcus_x: int = 0
    num_mcus_y: int = 0
    num_subsequences: int = 0
    num_segments: int = 0
    # int32[num_segments, 2]: (subseq_offset, subseq_count)
    segments: Optional[np.ndarray] = None
    # int64[num_segments, 2]: stuffed byte span (start, end) of each segment
    # relative to `begin` — end excludes the RST marker. Lets the native
    # destuffer process segments in parallel (they are independent).
    seg_raw: Optional[np.ndarray] = None
    # snapshot of the 8 Huffman tables at SOS time, layout [dc0,ac0,dc1,...]
    huff_tables: Optional[List[HuffmanTable]] = None

    @property
    def interleaved(self) -> bool:
        return len(self.components) > 1

    @property
    def num_mcus(self) -> int:
        return self.num_mcus_x * self.num_mcus_y

    @property
    def total_data_units(self) -> int:
        return self.num_mcus * self.num_data_units_in_mcu


@dataclasses.dataclass
class JpegStream:
    size_x: int = 0
    size_y: int = 0
    num_components: int = 0
    components: List[Component] = dataclasses.field(default_factory=list)
    ss_max_x: int = 1
    ss_max_y: int = 1
    restart_interval: int = 0
    scans: List[Scan] = dataclasses.field(default_factory=list)
    # uint8[4][64], natural (raster) order
    qtables: Optional[np.ndarray] = None


class _Cursor:
    __slots__ = ("data", "pos")

    def __init__(self, data: np.ndarray):
        self.data = data
        self.pos = 0

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def u8(self) -> int:
        if self.remaining() < 1:
            raise IncompleteBitstream("unexpected end of stream")
        v = int(self.data[self.pos])
        self.pos += 1
        return v

    def u16(self) -> int:
        hi = self.u8()
        return (hi << 8) | self.u8()


def _numpy_walk(body: np.ndarray):
    """The segment walk in numpy: the scan's end (the offset of its
    terminating 0xFF in ``body``), each segment's stuffed byte span
    (int64[n, 2], relative to ``body``, the end excluding the RST marker)
    and its count of stuffed 0xFF00 pairs (int64[n])."""
    ff_pos = np.flatnonzero(body == 0xFF)
    if ff_pos.size and ff_pos[-1] == len(body) - 1:
        # 0xFF as final byte: treat as a scan terminator; the subsequent
        # marker read will report the stream as incomplete.
        nxt = np.concatenate((body[ff_pos[:-1] + 1], [np.uint8(1)]))
    else:
        nxt = body[ff_pos + 1] if ff_pos.size else np.empty(0, np.uint8)
    is_stuff = nxt == 0
    is_rst_m = (nxt >= C.MARKER_RST0) & (nxt <= C.MARKER_RST7)
    is_term = ~is_stuff & ~is_rst_m
    term_i = np.flatnonzero(is_term)
    if term_i.size == 0:
        raise InvalidJpeg("no end-of-image marker")
    scan_end_rel = int(ff_pos[term_i[0]])  # offset of terminating 0xFF
    in_scan = ff_pos < scan_end_rel
    rst_rel = ff_pos[in_scan & is_rst_m]  # 0xFF positions of RSTs
    stuff_rel = ff_pos[in_scan & is_stuff]

    # raw byte spans of segments (relative to the scan's first byte)
    seg_starts = np.concatenate(([0], rst_rel + 2))
    seg_ends = np.concatenate((rst_rel, [scan_end_rel]))
    # stuffed pairs inside each segment
    stuff_cum = np.searchsorted(stuff_rel, seg_ends)
    stuff_before = np.searchsorted(stuff_rel, seg_starts)
    seg_raw = np.stack([seg_starts, seg_ends], axis=1).astype(np.int64)
    return scan_end_rel, seg_raw, (stuff_cum - stuff_before).astype(np.int64)


def _set_segments(scan: Scan, seg_raw: np.ndarray,
                  seg_stuffed: np.ndarray) -> None:
    """``scan``'s segment fields from the walk's spans and stuffed-pair
    counts."""
    # each stuffed pair is 1 data byte in 2 raw bytes (the 0x00 is
    # dropped, the 0xFF kept)
    seg_bytes = (seg_raw[:, 1] - seg_raw[:, 0]) - seg_stuffed
    n = len(seg_bytes)
    # (offset, count) of each segment's subsequences
    segments = np.empty((n, 2), np.int32)
    segments[:, 1] = (seg_bytes + (C.SUBSEQ_SIZE_BYTES - 1)) // C.SUBSEQ_SIZE_BYTES
    segments[0, 0] = 0
    np.cumsum(segments[:-1, 1], out=segments[1:, 0])
    scan.segments = segments
    scan.seg_raw = seg_raw
    scan.num_segments = n
    scan.num_subsequences = int(segments[-1].sum())


# The native pass's error codes, 1 on, as ``native/header.cpp`` numbers
# them: the exception class and message the Python parser raises for the
# same condition (None: the class's default); ``{0}`` is the code's
# argument, ``{name}`` the argument as a marker's name.
_NATIVE_ERRORS = (
    (InvalidJpeg, None),
    (IncompleteBitstream, None),
    (IncompleteBitstream, "unexpected end of stream"),
    (InvalidJpeg, "too few bytes for marker"),
    (InvalidJpeg, "invalid marker byte 0x{0:02x}"),
    (NotSupported, "sample precision {0}, only 8 supported"),
    (InvalidJpeg, "invalid size"),
    (InvalidJpeg, "zero components"),
    (NotSupported, "too many components: {0}"),
    (InvalidJpeg, "invalid subsampling factor"),
    (InvalidJpeg, "invalid quantization table index"),
    (InvalidJpeg, "invalid Huffman table class"),
    (NotSupported, "Huffman table index must be in [0,3]"),
    (InvalidJpeg, "too many values"),
    (InvalidJpeg, "overfull Huffman code space"),
    (InvalidJpeg, "invalid DQT precision or id"),
    (NotSupported, "16-bit quantization table"),
    (NotSupported, "redefined restart interval"),
    (InvalidJpeg, "SOS before SOF"),
    (InvalidJpeg, "invalid number of scan components"),
    (InvalidJpeg, "too many scans (component redefinition)"),
    (InvalidJpeg, "invalid component selector"),
    (InvalidJpeg, "invalid component order in scan"),
    (InvalidJpeg, "component defined in two scans"),
    (InvalidJpeg, "Huffman table id out of bounds"),
    (InvalidJpeg, "undefined DC table"),
    (InvalidJpeg, "undefined AC table"),
    (InvalidJpeg, "undefined quantization table"),
    (InvalidJpeg, "too many data units in MCU"),
    (InvalidJpeg, "no end-of-image marker"),
    (InvalidJpeg, "missing SOI"),
    (InvalidJpeg, "multiple SOF"),
    (NotSupported, "unsupported JPEG type {name}"),
    (InvalidJpeg, "no SOF"),
    (InvalidJpeg, "component {0} not defined in any scan"),
)


def parse(data: bytes | np.ndarray, *, log=None) -> JpegStream:
    """Parse a baseline JPEG, returning the full stream model.

    Raises the status-mapped exceptions of :mod:`jpeggpu_tpu_torch.errors` on
    malformed or unsupported input (same conditions as the reference
    reader.cpp, cited per check in :func:`_parse_python`). ``log`` receives
    a line per marker after SOI.
    """
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    out = native.header_pass(buf, with_markers=log is not None)
    if out is None or out.code == native.PARSE_FALLBACK:
        parses["python"] += 1
        return _parse_python(buf, log)
    parses["native"] += 1
    if log:
        for m in out.markers.tolist():
            log(f"marker {C.marker_name(m)}")
    if out.code != native.PARSE_OK:
        cls, msg = _NATIVE_ERRORS[-out.code - 1]
        if msg is None:
            raise cls()
        arg = out.header[native.ERROR_ARG]
        raise cls(msg.format(arg, name=C.marker_name(arg)))
    return _from_native(out)


def _from_native(out: native.HeaderPass) -> JpegStream:
    """The stream the native pass describes (``native``'s HDR_* layout)."""
    h = out.header
    comp0 = native.HDR_GLOBALS
    components = [Component(*h[o:o + native.HDR_COMP]) for o in range(
        comp0, comp0 + h[native.NUM_COMPONENTS] * native.HDR_COMP,
        native.HDR_COMP)]
    # each definition wrapped once; nothing downstream writes to a table
    pool = out.pool[:h[native.NUM_POOL]]
    pool.flags.writeable = False
    arrays = [pool[f] for f in ("maxcode", "valptr_sub_mincode", "huffval",
                                "lut_value", "lut_nbits")]
    tables = [HuffmanTable(*(a[i] for a in arrays), n, bool(saturated))
              for i, (n, saturated) in enumerate(zip(
                  pool["num_symbols"].tolist(), pool["saturated"].tolist()))]
    scans = []
    scan0 = comp0 + C.MAX_COMPONENTS * native.HDR_COMP
    for o in range(scan0, scan0 + h[native.NUM_SCANS] * native.HDR_SCAN,
                   native.HDR_SCAN):
        begin, end, du_in_mcu, mcus_x, mcus_y, n_seg, seg0, n_sc = \
            h[o:o + native.HDR_SCAN_HEAD]
        slots = h[o + native.HDR_SCAN_HEAD:o + native.HDR_SCAN_HEAD + native.HDR_SLOTS]
        comps = o + native.HDR_SCAN_HEAD + native.HDR_SLOTS
        scan = Scan(
            components=[ScanComponent(*h[c:c + native.HDR_SCAN_COMP])
                        for c in range(comps, comps + n_sc * native.HDR_SCAN_COMP,
                                       native.HDR_SCAN_COMP)],
            begin=begin, end=end, num_data_units_in_mcu=du_in_mcu,
            num_mcus_x=mcus_x, num_mcus_y=mcus_y,
            huff_tables=[tables[i] for i in slots])
        _set_segments(scan, out.seg_raw[seg0:seg0 + n_seg],
                      out.seg_stuffed[seg0:seg0 + n_seg])
        scans.append(scan)
    walks["native"] += len(scans)
    return JpegStream(
        size_x=h[native.SIZE_X], size_y=h[native.SIZE_Y],
        num_components=h[native.NUM_COMPONENTS], components=components,
        ss_max_x=h[native.SS_MAX_X], ss_max_y=h[native.SS_MAX_Y],
        restart_interval=h[native.RESTART_INTERVAL], scans=scans,
        qtables=out.qtables)


def _parse_python(buf: np.ndarray, log=None) -> JpegStream:
    """The parser in Python: :func:`parse`'s result from the same bytes,
    for a machine with no C++ compiler or a scan body with more restart
    segments than its header allows."""
    cur = _Cursor(buf)
    stream = JpegStream()
    stream.qtables = np.zeros((C.MAX_COMPONENTS, 64), np.uint8)

    # mutable parser state
    found_sof = False
    qtable_defined = [False] * 4
    qtable_locked = [False] * 4  # referenced by an already-parsed scan
    huff_defined = [False] * C.MAX_HUFF_PER_SCAN
    cur_huff: List[HuffmanTable] = [HuffmanTable.empty() for _ in range(C.MAX_HUFF_PER_SCAN)]
    comps_seen = [False] * C.MAX_COMPONENTS

    def read_marker() -> int:
        if cur.remaining() < 2:
            raise InvalidJpeg("too few bytes for marker")
        ff = cur.u8()
        if ff != 0xFF:
            raise InvalidJpeg(f"invalid marker byte 0x{ff:02x}")
        m = cur.u8()
        # B.1.1.2: any number of 0xFF fill bytes may precede the marker code
        while m == 0xFF:
            m = cur.u8()
        return m

    def read_sof() -> None:
        nonlocal found_sof
        if cur.remaining() < 2:
            raise InvalidJpeg()
        length = cur.u16()
        if length < 2:
            raise InvalidJpeg()
        if cur.remaining() < length - 2:
            raise IncompleteBitstream()
        precision = cur.u8()
        if precision != 8:  # reader.cpp:95-99
            raise NotSupported(f"sample precision {precision}, only 8 supported")
        num_lines = cur.u16()
        num_samples = cur.u16()
        if num_lines == 0 or num_samples == 0:
            raise InvalidJpeg("invalid size")
        stream.size_x = num_samples
        stream.size_y = num_lines
        n = cur.u8()
        if n == 0:
            raise InvalidJpeg("zero components")
        if n > C.MAX_COMPONENTS:  # reader.cpp:114-117
            raise NotSupported(f"too many components: {n}")
        stream.num_components = n
        if cur.remaining() < 3 * n:
            raise IncompleteBitstream()
        stream.ss_max_x = stream.ss_max_y = 0
        for _ in range(n):
            comp = Component()
            comp.id = cur.u8()
            sf = cur.u8()
            ss_x, ss_y = sf >> 4, sf & 0xF
            if not (1 <= ss_x <= 4) or not (1 <= ss_y <= 4):  # reader.cpp:137-145
                raise InvalidJpeg("invalid subsampling factor")
            if n == 1:
                # single-component: factors are ignored (reader.cpp:147-153)
                ss_x = ss_y = 1
            comp.ss_x, comp.ss_y = ss_x, ss_y
            qi = cur.u8()
            if qi > 3:
                raise InvalidJpeg("invalid quantization table index")
            comp.qtable_idx = qi
            stream.components.append(comp)
            stream.ss_max_x = max(stream.ss_max_x, ss_x)
            stream.ss_max_y = max(stream.ss_max_y, ss_y)
        for comp in stream.components:
            # A.1.1 component size
            comp.size_x = -(-stream.size_x * comp.ss_x // stream.ss_max_x)
            comp.size_y = -(-stream.size_y * comp.ss_y // stream.ss_max_y)
        found_sof = True

    def read_dht() -> None:
        if cur.remaining() < 2:
            raise InvalidJpeg()
        length = cur.u16() - 2
        if cur.remaining() < length:
            raise InvalidJpeg()
        remaining = length
        while remaining > 0:
            index = cur.u8()
            remaining -= 1
            table_class = index >> 4
            th = index & 0xF
            if table_class not in (0, 1):
                raise InvalidJpeg("invalid Huffman table class")
            if th > 3:  # reader.cpp:250-253
                raise NotSupported("Huffman table index must be in [0,3]")
            if remaining < 16:
                raise InvalidJpeg()
            num_codes = np.array([cur.u8() for _ in range(16)], np.uint8)
            remaining -= 16
            count = int(num_codes.sum())
            if remaining < count:
                raise InvalidJpeg()
            if count > C.HUFFMAN_ALPHABET_SIZE:
                raise InvalidJpeg("too many values")
            values = buf[cur.pos:cur.pos + count].copy()
            cur.pos += count
            remaining -= count
            slot = th * C.HUFF_COUNT + table_class
            cur_huff[slot] = build_huffman_table(num_codes, values)
            huff_defined[slot] = True

    def read_dqt() -> None:
        if cur.remaining() < 2:
            raise InvalidJpeg()
        length = cur.u16() - 2
        if cur.remaining() < length:
            raise InvalidJpeg()
        remaining = length
        while remaining > 0:
            info = cur.u8()
            remaining -= 1
            precision = info >> 4
            tid = info & 0xF
            if precision not in (0, 1) or tid > 3:
                raise InvalidJpeg("invalid DQT precision or id")
            if precision != 0:  # reader.cpp:517-520
                raise NotSupported("16-bit quantization table")
            if remaining < 64:
                raise InvalidJpeg()
            vals = buf[cur.pos:cur.pos + 64]
            cur.pos += 64
            remaining -= 64
            qtable_defined[tid] = True
            # Redefinitions after a scan already uses the table are ignored so
            # earlier scans keep decoding with the table they were coded with
            # (single-snapshot model, cf. reader.cpp:524-544).
            if not qtable_locked[tid]:
                # store zig-zag -> natural
                stream.qtables[tid, C.ORDER_NATURAL] = vals

    def read_dri() -> None:
        if cur.remaining() < 2:
            raise InvalidJpeg()
        length = cur.u16() - 2
        if cur.remaining() < length:
            raise InvalidJpeg()
        rsti = cur.u16()
        if stream.restart_interval and stream.restart_interval != rsti:
            raise NotSupported("redefined restart interval")  # reader.cpp:563-569
        stream.restart_interval = rsti

    def skip_segment() -> None:
        if cur.remaining() < 2:
            raise InvalidJpeg()
        length = cur.u16()
        if length < 2:
            raise InvalidJpeg()
        if cur.remaining() < length - 2:
            raise IncompleteBitstream()
        cur.pos += length - 2

    def read_sos() -> None:
        if not found_sof:
            raise InvalidJpeg("SOS before SOF")
        if cur.remaining() < 3:
            raise InvalidJpeg()
        length = cur.u16()
        if length < 3:
            raise InvalidJpeg()
        n_sc = cur.u8()
        if not (1 <= n_sc <= 4):
            raise InvalidJpeg("invalid number of scan components")
        if len(stream.scans) >= C.MAX_SCANS:
            raise InvalidJpeg("too many scans (component redefinition)")
        scan = Scan()
        if length - 3 != 2 * n_sc + 3:
            raise InvalidJpeg()
        if cur.remaining() < 2 * n_sc + 3:
            raise IncompleteBitstream()

        for sc in range(n_sc):
            selector = cur.u8()
            acdc = cur.u8()
            id_dc, id_ac = acdc >> 4, acdc & 0xF
            comp_idx = next(
                (i for i, c in enumerate(stream.components) if c.id == selector), -1)
            if comp_idx == -1:
                raise InvalidJpeg("invalid component selector")
            # A.2: component order in scan must follow frame order (reader.cpp:369-372)
            if sc > 0 and comp_idx <= scan.components[-1].component_idx:
                raise InvalidJpeg("invalid component order in scan")
            if comps_seen[comp_idx]:
                raise InvalidJpeg("component defined in two scans")
            comps_seen[comp_idx] = True
            if id_dc > 3 or id_ac > 3:
                raise InvalidJpeg("Huffman table id out of bounds")
            if not huff_defined[id_dc * C.HUFF_COUNT + C.HUFF_DC]:
                raise InvalidJpeg("undefined DC table")
            if not huff_defined[id_ac * C.HUFF_COUNT + C.HUFF_AC]:
                raise InvalidJpeg("undefined AC table")
            comp = stream.components[comp_idx]
            if not qtable_defined[comp.qtable_idx]:
                raise InvalidJpeg("undefined quantization table")
            qtable_locked[comp.qtable_idx] = True
            scan.components.append(ScanComponent(comp_idx, id_dc, id_ac))

        interleaved = n_sc > 1
        du_in_mcu = 0
        for sc_obj in scan.components:
            comp = stream.components[sc_obj.component_idx]
            sc_obj.mcu_size_x = 8 * comp.ss_x if interleaved else 8
            sc_obj.mcu_size_y = 8 * comp.ss_y if interleaved else 8
            sc_obj.data_size_x = -(-comp.size_x // sc_obj.mcu_size_x) * sc_obj.mcu_size_x
            sc_obj.data_size_y = -(-comp.size_y // sc_obj.mcu_size_y) * sc_obj.mcu_size_y
            scan.num_mcus_x = sc_obj.data_size_x // sc_obj.mcu_size_x
            scan.num_mcus_y = sc_obj.data_size_y // sc_obj.mcu_size_y
            sc_obj.off_in_mcu = du_in_mcu
            sc_obj.du_per_mcu = comp.ss_x * comp.ss_y if interleaved else 1
            du_in_mcu += sc_obj.du_per_mcu
        scan.num_data_units_in_mcu = du_in_mcu
        if du_in_mcu > 10:  # B.2.3 (reader.cpp:424-428)
            raise InvalidJpeg("too many data units in MCU")

        cur.u8()  # spectral start
        cur.u8()  # spectral end
        cur.u8()  # successive approximation
        scan.huff_tables = [t.copy() for t in cur_huff]

        # --- segment discovery (memchr walk, reader.cpp:443-489) ---
        scan.begin = cur.pos
        body = buf[cur.pos:]
        # segments the header allows; each but the last ends in a 2-byte RST
        ri = stream.restart_interval
        cap = min(-(-scan.num_mcus // ri) if ri else 1, len(body) // 2 + 1)
        found = native.segment_walk(body, cap)
        if found is None:
            found = _numpy_walk(body)
            walks["numpy"] += 1
        else:
            walks["native"] += 1
        scan_end_rel, seg_raw, seg_stuffed = found
        _set_segments(scan, seg_raw, seg_stuffed)
        scan.end = cur.pos + scan_end_rel
        cur.pos = scan.end
        stream.scans.append(scan)

    # ---- marker loop (reader.cpp:596-649) ----
    m = read_marker()
    if m != C.MARKER_SOI:
        raise InvalidJpeg("missing SOI")
    while True:
        m = read_marker()
        if log:
            log(f"marker {C.marker_name(m)}")
        if m in (C.MARKER_SOF0, C.MARKER_SOF1):
            if found_sof:
                raise InvalidJpeg("multiple SOF")
            read_sof()
        elif m in C._UNSUPPORTED_SOFS:
            raise NotSupported(f"unsupported JPEG type {C.marker_name(m)}")
        elif m == C.MARKER_DHT:
            read_dht()
        elif m == C.MARKER_EOI:
            break
        elif m == C.MARKER_SOS:
            read_sos()
        elif m == C.MARKER_DQT:
            read_dqt()
        elif m == C.MARKER_DRI:
            read_dri()
        else:
            skip_segment()

    if not found_sof:
        raise InvalidJpeg("no SOF")
    for c in range(stream.num_components):
        if not comps_seen[c]:
            raise InvalidJpeg(f"component {c} not defined in any scan")
    return stream


def num_mcus_in_segment(stream: JpegStream, scan: Scan) -> int:
    """MCUs per restart segment (the whole scan if no restart interval)."""
    return stream.restart_interval if stream.restart_interval else scan.num_mcus
