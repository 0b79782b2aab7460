"""PyTorch port, the reader (``reader.parse``) on the CPU.

The native walk (``native.segment_walk``, one memchr pass) equals the
numpy walk (``reader._numpy_walk``) on every body: the scan's end, each
segment's stuffed span and its count of stuffed pairs, or the same error.
The native header pass (``native/header.cpp``, what ``reader.parse`` runs)
and the Python parser (``reader._parse_python``, with either walk) give
the same stream field by field, every Huffman table array and the
quantization tables included, and the same log lines, or the same
exception class and message; the native stream also equals the JAX
package's ``reader.parse``. That holds on the port encoder's streams,
PIL's (4:4:4, 4:2:2, 4:2:0, grayscale, optimised tables, a restart marker
every MCU row), hand-edited ones, every truncation of two streams and
single-byte changes of their headers. A body with more restart segments
than its header allows sends the stream to the Python parser and its
numpy walk. ``reader.parses`` counts the streams each parser took,
``reader.walks`` the scans each walk took. Tolerance: none.
"""

import dataclasses
import io

import numpy as np
import pytest
from PIL import Image

from jpeggpu_tpu import reader as jax_reader
from jpeggpu_tpu.errors import JpegError as JaxJpegError
from jpeggpu_tpu_torch import constants as C
from jpeggpu_tpu_torch import native, reader
from jpeggpu_tpu_torch.encoder import EncodeSpec, encode
from jpeggpu_tpu_torch.errors import JpegError
from torch_cases import saturated_stream

S420 = [(2, 2), (1, 1), (1, 1)]
SCAN_FIELDS = ("begin", "end", "seg_raw", "segments", "num_segments",
               "num_subsequences")


def _first_rst(data: bytes) -> int:
    """Offset of the first RST marker's 0xFF after the first SOS."""
    body = data.index(bytes([0xFF, C.MARKER_SOS]))
    return next(i for i in range(body, len(data) - 1)
                if data[i] == 0xFF and C.MARKER_RST0 <= data[i + 1] <= C.MARKER_RST7)


def _set_dri(data: bytes, interval: int) -> bytes:
    at = data.index(bytes([0xFF, C.MARKER_DRI])) + 4
    return data[:at] + interval.to_bytes(2, "big") + data[at + 2:]


def _stream(name: str, image: np.ndarray) -> bytes:
    # 48x45 at 4:2:0: 3 x 3 MCUs, so one a segment reaches RST7
    small = image[:, :48]
    if name == "no_dri":
        return encode(small, EncodeSpec(sampling=S420))
    if name == "rst_every_row":
        return encode(small, EncodeSpec(sampling=S420, restart_interval=3))
    if name == "rst_every_mcu":
        return encode(small, EncodeSpec(sampling=S420, restart_interval=1))
    if name == "stuffed_before_rst":
        data = _stream("rst_every_mcu", image)
        at = _first_rst(data)
        return data[:at] + b"\xff\x00" + data[at:]
    if name == "fill_before_eoi":
        data = _stream("rst_every_row", image)
        assert data.endswith(b"\xff\xd9")
        return data[:-2] + b"\xff\xff\xff\xd9"
    if name == "lone_ff_last":
        return _stream("rst_every_row", image)[:-1]
    if name == "no_terminator":
        return _stream("rst_every_row", image)[:-2]
    if name == "more_rst_than_dri":
        # nine segments under a DRI that allows one
        return _set_dri(_stream("rst_every_mcu", image), 9)
    raise KeyError(name)


CASES = ("no_dri", "rst_every_row", "rst_every_mcu", "stuffed_before_rst",
         "fill_before_eoi", "lone_ff_last", "no_terminator",
         "more_rst_than_dri")


def _python_parse(data, *, log=None):
    return reader._parse_python(np.frombuffer(data, np.uint8), log)


def _outcome(parse, data):
    """The first scan's fields, or the error's class name and message."""
    try:
        scan = parse(data).scans[0]
    except (JpegError, JaxJpegError) as e:
        return ("error", type(e).__name__, str(e))
    return tuple(np.asarray(getattr(scan, f)).tolist() for f in SCAN_FIELDS)


def _walk(walk):
    try:
        end, raw, stuffed = walk()
    except JpegError as e:
        return ("error", type(e).__name__, str(e))
    return end, raw.tolist(), stuffed.tolist()


@pytest.mark.parametrize("name", CASES)
def test_native_walk_equals_numpy_walk_and_jax_parse(name, test_image, monkeypatch):
    assert native.get_lib() is not None
    data = _stream(name, test_image)
    buf = np.frombuffer(data, np.uint8)
    # the body follows the SOS segment, whose length counts itself
    sos = data.index(bytes([0xFF, C.MARKER_SOS]))
    body = buf[sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big"):]
    # room for every segment the body could hold
    cap = len(body) // 2 + 1
    assert (_walk(lambda: native.segment_walk(body, cap))
            == _walk(lambda: reader._numpy_walk(body)))
    if name == "more_rst_than_dri":
        assert native.segment_walk(body, 1) is None

    before = dict(reader.walks)
    got_native = _outcome(reader.parse, data)
    took = {k: reader.walks[k] - before[k] for k in before}
    got_python = _outcome(_python_parse, data)
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        got_numpy = _outcome(reader.parse, data)
    assert (got_native == got_python == got_numpy
            == _outcome(jax_reader.parse, data))
    if name == "no_terminator":
        assert got_native == ("error", "InvalidJpeg", "no end-of-image marker")
    elif name == "lone_ff_last":
        assert got_native[:2] == ("error", "InvalidJpeg")
    else:
        assert got_native[SCAN_FIELDS.index("num_segments")] > 0
        # the overflow takes the numpy walk, every other scan the native
        overflow = name == "more_rst_than_dri"
        assert took == {"native": int(not overflow), "numpy": int(overflow)}


def test_walks_counts_one_native_walk_a_scan(test_image):
    assert native.get_lib() is not None
    data = encode(test_image[:24, :40], EncodeSpec(
        sampling=S420, interleaved=False, restart_interval=2))
    before = dict(reader.walks)
    stream = reader.parse(data)
    assert len(stream.scans) == 3
    assert reader.walks["native"] - before["native"] == 3
    assert reader.walks["numpy"] == before["numpy"]


# --- the native header pass against the Python parser ----------------------

def _pil(image: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(image).save(out, "JPEG", quality=90, **kw)
    return out.getvalue()


def _split(data: bytes):
    """The segments between SOI and the first SOS, as (marker, payload),
    and the bytes from the first SOS on."""
    segs, at = [], 2
    while data[at + 1] != C.MARKER_SOS:
        n = int.from_bytes(data[at + 2:at + 4], "big")
        segs.append((data[at + 1], data[at + 4:at + 2 + n]))
        at += 2 + n
    return segs, data[at:]


def _join(segs, rest: bytes) -> bytes:
    return (b"\xff\xd8" + b"".join(bytes([0xFF, m]) + (len(p) + 2).to_bytes(2, "big")
                               + p for m, p in segs) + rest)


def _second_sos(data: bytes) -> int:
    return data.index(bytes([0xFF, C.MARKER_SOS]),
                      data.index(bytes([0xFF, C.MARKER_SOS])) + 2)


def _field_stream(name: str, image: np.ndarray) -> bytes:
    small = image[:, :48]
    gray = np.ascontiguousarray(image[..., 0])
    if name in CASES:
        return _stream(name, image)
    if name.startswith("pil_"):
        return {
            "pil_444": lambda: _pil(image, subsampling=0),
            "pil_422": lambda: _pil(image, subsampling=1),
            "pil_420": lambda: _pil(image, subsampling=2),
            "pil_gray": lambda: _pil(gray),
            "pil_420_optimized": lambda: _pil(image, subsampling=2, optimize=True),
            "pil_444_rst_every_row": lambda: _pil(
                image, subsampling=0, restart_marker_rows=1),
            "pil_gray_optimized_rst_every_row": lambda: _pil(
                gray, optimize=True, restart_marker_rows=1),
            # 34 x 34 MCUs, a segment each: past the first call's room
            "pil_444_rst_every_mcu": lambda: _pil(
                np.tile(image, (6, 4, 1)), subsampling=0,
                restart_marker_blocks=1),
        }[name]()
    if name == "two_tables_one_dht":
        segs, rest = _split(_stream("rst_every_row", image))
        dht = b"".join(p for m, p in segs if m == C.MARKER_DHT)
        first = next(i for i, (m, _) in enumerate(segs) if m == C.MARKER_DHT)
        segs = [s for s in segs if s[0] != C.MARKER_DHT]
        return _join(segs[:first] + [(C.MARKER_DHT, dht)] + segs[first:], rest)
    if name == "dht_between_scans":
        return encode(small, EncodeSpec(sampling=S420, interleaved=False,
                                        dht_per_scan=True))
    if name == "dqt_after_lock":
        # after the first scan (component 0, table 0): table 0 redefined,
        # which that scan locked, and table 1, which no scan has used yet
        data = encode(small, EncodeSpec(sampling=S420, interleaved=False))
        at = _second_sos(data)
        payload = bytes([0]) + bytes(range(1, 65)) + bytes([1]) + bytes(range(2, 66))
        return (data[:at] + bytes([0xFF, C.MARKER_DQT])
                + (len(payload) + 2).to_bytes(2, "big") + payload + data[at:])
    if name == "app_and_com":
        segs, rest = _split(_stream("rst_every_row", image))
        extra = [(C.MARKER_APP0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
                 (C.MARKER_COM, b"a comment")]
        segs = extra + segs[:2] + [(C.MARKER_APP0 + 14, b"Adobe" + bytes(7))] + segs[2:]
        data = encode(small, EncodeSpec(sampling=S420, interleaved=False))
        at = _second_sos(data)
        between = bytes([0xFF, C.MARKER_COM, 0, 5]) + b"mid"
        return _join(segs, rest), data[:at] + between + data[at:]
    if name == "fill_before_markers":
        data = _stream("rst_every_row", image)
        for m in (C.MARKER_SOF0, C.MARKER_DRI, C.MARKER_SOS):
            data = data.replace(bytes([0xFF, m]), bytes([0xFF, 0xFF, 0xFF, m]), 1)
        return data
    if name == "overfull_dht":
        segs, rest = _split(_stream("rst_every_row", image))
        i = next(i for i, (m, _) in enumerate(segs) if m == C.MARKER_DHT)
        p = segs[i][1]
        total = sum(p[1:17])
        # three 1-bit codes: past the code space at the first length
        counts = bytes([3] + [0] * 14 + [total - 3])
        segs[i] = (C.MARKER_DHT, p[:1] + counts + p[17:])
        return _join(segs, rest)
    if name == "saturated_table":
        return saturated_stream()
    return _error_stream(name, image)


def _error_stream(name: str, image: np.ndarray) -> bytes:
    """A stream edited so that the parse stops at one condition."""
    small = image[:16, :16]
    data = _stream("rst_every_row", image)
    segs, rest = _split(data)
    kinds = [m for m, _ in segs]
    sof = kinds.index(C.MARKER_SOF0)
    non_interleaved = encode(small, EncodeSpec(sampling=S420, interleaved=False))
    second = _second_sos(non_interleaved)
    third = non_interleaved.index(bytes([0xFF, C.MARKER_SOS]), second + 2)
    if name == "end_of_stream_in_fill":
        return b"\xff\xd8\xff\xff"
    if name == "dqt_16_bit":
        i = kinds.index(C.MARKER_DQT)
        segs[i] = (C.MARKER_DQT, bytes([0x10]) + segs[i][1][1:])
        return _join(segs, rest)
    if name == "redefined_dri":
        return _join(segs + [(C.MARKER_DRI, (5).to_bytes(2, "big"))], rest)
    if name == "too_many_scans":
        four = [small[..., 0], small[..., 1], small[..., 2], small[..., 0]]
        data = encode(four, EncodeSpec(sampling=[(1, 1)] * 4, interleaved=False))
        last = data.rindex(bytes([0xFF, C.MARKER_SOS]))
        return data[:-2] + data[last:-2] + data[-2:]
    if name == "component_in_two_scans":
        return non_interleaved[:third] + non_interleaved[second:]
    if name == "too_many_data_units":
        p = bytearray(segs[sof][1])
        p[7] = 0x44  # component 0 at 4x4: 16 + 1 + 1 units an MCU
        segs[sof] = (C.MARKER_SOF0, bytes(p))
        return _join(segs, rest)
    if name == "multiple_sof":
        return _join(segs[:sof + 1] + segs[sof:], rest)
    if name == "no_sof":
        return b"\xff\xd8\xff\xd9"
    if name == "component_not_in_scan":
        return non_interleaved[:third] + b"\xff\xd9"
    if name == "too_many_values":
        return _join(segs + [(C.MARKER_DHT, bytes([0x02] + [17] * 16 + [0] * 272))],
                     rest)
    if name == "unsupported_sof":
        segs[sof] = (0xC2, segs[sof][1])
        return _join(segs, rest)
    raise KeyError(name)


# each edited stream's error, the same from every parser
ERRORS = {
    "overfull_dht": ("InvalidJpeg", "overfull Huffman code space"),
    "end_of_stream_in_fill": ("IncompleteBitstream", "unexpected end of stream"),
    "dqt_16_bit": ("NotSupported", "16-bit quantization table"),
    "redefined_dri": ("NotSupported", "redefined restart interval"),
    "too_many_scans": ("InvalidJpeg", "too many scans (component redefinition)"),
    "component_in_two_scans": ("InvalidJpeg", "component defined in two scans"),
    "too_many_data_units": ("InvalidJpeg", "too many data units in MCU"),
    "multiple_sof": ("InvalidJpeg", "multiple SOF"),
    "no_sof": ("InvalidJpeg", "no SOF"),
    "component_not_in_scan": ("InvalidJpeg", "component 2 not defined in any scan"),
    "too_many_values": ("InvalidJpeg", "too many values"),
    "unsupported_sof": ("NotSupported", "unsupported JPEG type SOF2"),
}


PIL_CASES = ("pil_444", "pil_422", "pil_420", "pil_gray", "pil_420_optimized",
             "pil_444_rst_every_row", "pil_gray_optimized_rst_every_row",
             "pil_444_rst_every_mcu")
EDITED_CASES = ("two_tables_one_dht", "dht_between_scans", "dqt_after_lock",
                "app_and_com", "fill_before_markers", "saturated_table")


def _canon(obj):
    """Every field of a parse result, recursively; arrays with their dtype
    and shape."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, _canon(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tolist())
    if isinstance(obj, list):
        return [_canon(x) for x in obj]
    return obj


def _parsed(parse, data: bytes):
    """The whole stream, or the error's class and message; and the log."""
    lines = []
    try:
        got = _canon(parse(data, log=lines.append))
    except (JpegError, JaxJpegError) as e:
        got = ("error", type(e).__name__, str(e))
    return got, lines


@pytest.mark.parametrize("name", CASES + PIL_CASES + EDITED_CASES + tuple(ERRORS))
def test_native_pass_equals_python_parser_field_by_field(name, test_image):
    assert native.get_lib() is not None
    datas = _field_stream(name, test_image)
    for data in datas if isinstance(datas, tuple) else (datas,):
        before = dict(reader.parses)
        got = _parsed(reader.parse, data)
        took = {k: reader.parses[k] - before[k] for k in before}
        assert got == _parsed(_python_parse, data)
        assert got == _parsed(jax_reader.parse, data)
        overflow = name == "more_rst_than_dri"
        assert took == {"native": int(not overflow), "python": int(overflow)}
        if name in ERRORS:
            assert got[0] == ("error",) + ERRORS[name]
        elif name not in ("lone_ff_last", "no_terminator"):
            assert got[0][0] == "JpegStream"
    if name == "pil_444_rst_every_mcu":
        assert reader.parse(data).scans[0].num_segments == 34 * 34
    if name == "saturated_table":
        stream = reader.parse(data)
        assert any(t.saturated for t in stream.scans[0].huff_tables)
    if name == "dqt_after_lock":
        zigzag = reader.parse(data).qtables[:, C.ORDER_NATURAL]
        assert zigzag[0].tolist() != list(range(1, 65))  # ignored
        assert zigzag[1].tolist() == list(range(2, 66))


def _small_streams(image):
    return {"interleaved_dri": _stream("rst_every_row", image[:16, :16]),
            "per_scan_dht": encode(image[:16, :16], EncodeSpec(
                sampling=S420, interleaved=False, dht_per_scan=True))}


def _header_end(data: bytes) -> int:
    """One past the first SOS segment."""
    sos = data.index(bytes([0xFF, C.MARKER_SOS]))
    return sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")


def _edits(data: bytes, kind: str):
    if kind == "truncated":
        return [data[:n] for n in range(len(data))]
    change = {"zero": lambda b: 0x00, "ff": lambda b: 0xFF,
              "xor01": lambda b: b ^ 0x01, "xor80": lambda b: b ^ 0x80}[kind]
    return [data[:i] + bytes([change(data[i])]) + data[i + 1:]
            for i in range(_header_end(data)) if change(data[i]) != data[i]]


@pytest.mark.parametrize("kind", ["truncated", "zero", "ff", "xor01", "xor80"])
@pytest.mark.parametrize("stream", ["interleaved_dri", "per_scan_dht"])
def test_native_pass_errors_equal_python_parser(stream, kind, test_image):
    assert native.get_lib() is not None
    data = _small_streams(test_image)[stream]
    seen = set()
    for edited in _edits(data, kind):
        got = _parsed(reader.parse, edited)
        assert got == _parsed(_python_parse, edited), edited
        seen.add(got[0][:3] if got[0][0] == "error" else "ok")
    # the edits reach errors, not only the one
    assert len(seen) >= 3


def test_parses_counts_one_native_parse_a_stream(monkeypatch):
    assert native.get_lib() is not None
    rng = np.random.default_rng(7)
    # the shape of an ImageNet training JPEG: 500x375, 4:2:0, quality 90
    image = np.clip(rng.normal(128, 40, (375, 500, 3)), 0, 255).astype(np.uint8)
    data = _pil(image, subsampling=2)
    parses, walks = dict(reader.parses), dict(reader.walks)
    stream = reader.parse(data)
    assert {k: reader.parses[k] - parses[k] for k in parses} == {"native": 1, "python": 0}
    assert {k: reader.walks[k] - walks[k] for k in walks} == {
        "native": len(stream.scans), "numpy": 0}
    # each table wrapped once, read-only
    tables = stream.scans[0].huff_tables
    assert not any(t.maxcode.flags.writeable or t.lut_nbits.flags.writeable
                   for t in tables)
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        parses = dict(reader.parses)
        fallback = reader.parse(data)
        assert {k: reader.parses[k] - parses[k] for k in parses} == {
            "native": 0, "python": 1}
    assert _canon(fallback) == _canon(stream)


def test_scans_share_a_table_they_both_hold(test_image):
    data = encode(test_image[:24, :40], EncodeSpec(sampling=S420,
                                                    interleaved=False))
    s0, s1, s2 = reader.parse(data).scans
    # chroma scans 1 and 2 hold the same definitions
    assert all(a is b for a, b in zip(s1.huff_tables, s2.huff_tables))
    assert s0.huff_tables[0] is s1.huff_tables[0]
