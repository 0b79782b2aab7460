"""Native (C++) host library, loaded via ctypes: the destuffer and the
parser's segment walk.

The shared library is compiled on first use from ``destuff.cpp`` and
``walk.cpp`` into the package's build directory. Where the machine has no
C++ compiler, :func:`get_lib` returns None and the caller takes the numpy
version (``golden.destuff_scan_host``, ``reader``'s numpy walk); a compiler
that is present but fails is an error, not a reason to fall back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from .._build_dir import library_path
from ..errors import InvalidJpeg

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, name) for name in ("destuff.cpp", "walk.cpp")]
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
