"""Native (C++) host library, loaded via ctypes: the destuffer, the
parser's segment walk and the header pass that calls it.

The shared library is compiled on first use from ``destuff.cpp``,
``walk.cpp`` and ``header.cpp`` into the package's build directory. Where
the machine has no C++ compiler, :func:`get_lib` returns None and the
caller takes the Python or numpy version (``golden.destuff_scan_host``,
``reader``'s Python parser and numpy walk); a compiler that is present but
fails is an error, not a reason to fall back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np

from .._build_dir import library_path
from ..errors import InvalidJpeg

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, name) for name in ("destuff.cpp", "walk.cpp",
                                                "header.cpp")]
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_loaded = False


def _load() -> ctypes.CDLL | None:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    so_path = library_path("jpeggpu_host", _SRCS, _FLAGS)
    if not os.path.exists(so_path):
        tmp = f"{so_path}.tmp{os.getpid()}"
        subprocess.run([cxx, *_FLAGS, "-o", tmp, *_SRCS], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.jpeggpu_destuff_words.restype = ctypes.c_int64
    lib.jpeggpu_destuff_words.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.jpeggpu_segment_walk.restype = ctypes.c_int64
    lib.jpeggpu_segment_walk.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jpeggpu_parse.restype = ctypes.c_int64
    lib.jpeggpu_parse.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64,
    ]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None on a machine with no C++
    compiler."""
    global _lib, _loaded
    with _lock:
        if not _loaded:
            _lib = _load()
            _loaded = True
        return _lib


def destuff_words(body: np.ndarray, seg_sub_offset: np.ndarray,
                  num_subseq: int, seg_raw: np.ndarray,
                  out: np.ndarray) -> bool:
    """Destuff straight into ``out``, the padded device word layout.

    One native pass on the calling thread writes the whole of ``out``
    (uint32[lanes * 32], C order; what it held before does not matter, so
    a reused staging buffer needs no clearing): each restart segment
    destuffed into its window of subsequences, zero padded, its words
    swapped to the host order in which the device bit reader takes them,
    and zeros past the last subsequence. ``seg_raw`` is the parser's per-segment stuffed byte
    spans. Returns False if the machine has no C++ compiler or the
    stream's segments do not fit their windows (the caller then takes the
    numpy destuffer, which clamps the same way).
    """
    if (out.dtype != np.uint32 or not out.flags.c_contiguous
            or not out.flags.writeable or out.size < num_subseq * 32):
        raise ValueError("out must be a writeable, C-contiguous uint32 "
                         f"array of at least {num_subseq * 32} words")
    lib = get_lib()
    if lib is None:
        return False
    body = np.ascontiguousarray(body, np.uint8)
    seg = np.ascontiguousarray(seg_sub_offset, np.int32)
    raw = np.ascontiguousarray(seg_raw, np.int64)
    # capacity bound is the real subsequence count: a corrupt final segment
    # must not bleed into the zero padding the decode relies on
    rc = lib.jpeggpu_destuff_words(
        body.ctypes.data, body.size, raw.ctypes.data, seg.ctypes.data,
        seg.size, out.ctypes.data, num_subseq, out.size)
    return rc >= 0


def segment_walk(body: np.ndarray, cap: int):
    """Find the end of the scan that starts at ``body[0]`` and split it at
    its restart markers, in one native pass on the calling thread.

    Returns ``(scan_end, seg_raw, seg_stuffed)``: the offset in ``body`` of
    the 0xFF that ends the scan, each segment's stuffed byte span
    (int64[n, 2], start and end, the end excluding the restart marker) and
    each segment's count of stuffed 0xFF00 pairs (int64[n]). Returns None
    where the machine has no C++ compiler or the body holds more than
    ``cap`` segments; the caller then takes the numpy walk. Raises
    ``InvalidJpeg`` if no marker ends the scan.
    """
    lib = get_lib()
    if lib is None:
        return None
    body = np.ascontiguousarray(body, np.uint8)
    seg_raw = np.empty((cap, 2), np.int64)
    seg_stuffed = np.empty(cap, np.int64)
    scan_end = ctypes.c_int64()
    n = lib.jpeggpu_segment_walk(
        body.ctypes.data, body.size, cap, seg_raw.ctypes.data,
        seg_stuffed.ctypes.data, ctypes.byref(scan_end))
    if n == -1:
        raise InvalidJpeg("no end-of-image marker")
    if n < 0:
        return None
    return scan_end.value, seg_raw[:n], seg_stuffed[:n]


# The header pass's output (``header.cpp``), one workspace: ``header``
# (int64[HDR_LEN]), the quantization tables (uint8[4, 64]), the Huffman
# table pool (HUFF_DTYPE[POOL_SIZE]), the segments' spans (int64[cap, 2])
# and stuffed-pair counts (int64[cap]), the markers (int32[...]).
# ``header`` holds the globals (their indices below), then MAX_COMPONENTS
# components of HDR_COMP fields (``reader.Component``'s, in its order), then
# MAX_SCANS scans of HDR_SCAN: HDR_SCAN_HEAD fields (``begin``, ``end``,
# ``num_data_units_in_mcu``, ``num_mcus_x``, ``num_mcus_y``,
# ``num_segments``, the first segment's index, the number of components),
# the pool entry of each of the 8 Huffman slots, then 4 components of
# HDR_SCAN_COMP fields (``reader.ScanComponent``'s, in its order).
(SIZE_X, SIZE_Y, NUM_COMPONENTS, SS_MAX_X, SS_MAX_Y, RESTART_INTERVAL,
 NUM_SCANS, NUM_POOL, NUM_MARKERS, ERROR_ARG, HDR_GLOBALS) = range(11)
HDR_COMP = 6
HDR_SCAN_HEAD, HDR_SLOTS, HDR_SCAN_COMP = 8, 8, 9
HDR_SCAN = HDR_SCAN_HEAD + HDR_SLOTS + 4 * HDR_SCAN_COMP
HDR_LEN = HDR_GLOBALS + 4 * HDR_COMP + 4 * HDR_SCAN
# one Huffman table of the pool, ``tables.HuffmanTable``'s arrays
HUFF_DTYPE = np.dtype([
    ("maxcode", "<i4", (16,)), ("valptr_sub_mincode", "<i4", (16,)),
    ("huffval", "u1", (256,)), ("lut_value", "u1", (256,)),
    ("lut_nbits", "u1", (256,)), ("num_symbols", "<i4"), ("saturated", "<i4"),
])
POOL_SIZE = 1 + 4 * 8  # the empty table, then at most 8 new ones a scan
_QTABLES_AT = HDR_LEN * 8
_POOL_AT = _QTABLES_AT + 4 * 64
_SEGMENTS_AT = _POOL_AT + POOL_SIZE * HUFF_DTYPE.itemsize
# header_pass's codes besides the errors (negative)
PARSE_OK, PARSE_FALLBACK, _NEED_SEGMENTS = 0, 1, 2
# segments the first call has room for; rarely exceeded (a 12 MP frame
# with a restart marker every MCU row has 189)
_FIRST_SEGMENT_CAP = 1024


class HeaderPass(NamedTuple):
    """What :func:`header_pass` wrote: its code, the ``header`` ints (the
    layout above), ``qtables`` (uint8[4, 64], natural order), the Huffman
    table ``pool`` (HUFF_DTYPE[POOL_SIZE], entry 0 the empty table), the
    walk's ``seg_raw`` (int64[n, 2]) and ``seg_stuffed`` (int64[n]) for all
    scans, and the markers read after SOI (int32, where asked for): views
    of one workspace."""

    code: int
    header: list
    qtables: np.ndarray
    pool: np.ndarray
    seg_raw: np.ndarray
    seg_stuffed: np.ndarray
    markers: np.ndarray


def header_pass(buf: np.ndarray, with_markers: bool = False):
    """All of one JPEG's header work in one native pass on the calling
    thread: markers, frame, quantization and Huffman tables (derived into
    their decode arrays), restart interval, scans, and each scan body's
    segment walk.

    Returns None where the machine has no C++ compiler, else a
    :class:`HeaderPass` whose ``code`` is PARSE_OK, PARSE_FALLBACK (a scan
    body holds more restart segments than its header allows: the caller
    takes the Python parser) or an error code negated, its argument at
    ``header[ERROR_ARG]``. ``with_markers`` records every marker read.
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = np.ascontiguousarray(buf, np.uint8)
    markers = buf.size // 2 + 1 if with_markers else 0
    # every segment but a scan's last ends in a 2-byte marker, so the
    # second call has room for all
    for cap in (min(_FIRST_SEGMENT_CAP, buf.size // 2 + 4), buf.size // 2 + 4):
        stuffed_at = _SEGMENTS_AT + cap * 16
        markers_at = stuffed_at + cap * 8
        work = np.empty(markers_at + markers * 4, np.uint8)
        code = lib.jpeggpu_parse(buf.ctypes.data, buf.size, work.ctypes.data,
                                 cap, markers)
        if code != _NEED_SEGMENTS:
            break
    header = work[:_QTABLES_AT].view(np.int64).tolist()
    return HeaderPass(
        code, header, work[_QTABLES_AT:_POOL_AT].reshape(4, 64),
        work[_POOL_AT:_SEGMENTS_AT].view(HUFF_DTYPE),
        work[_SEGMENTS_AT:stuffed_at].view(np.int64).reshape(cap, 2),
        work[stuffed_at:markers_at].view(np.int64),
        work[markers_at:].view(np.int32)[:header[NUM_MARKERS]])
