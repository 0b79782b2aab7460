"""Native (C++) host destuffer, loaded via ctypes.

The shared library is compiled on first use from ``destuff.cpp`` into the
package's build directory. Where the machine has no C++ compiler,
:func:`get_lib` returns None and the caller takes the numpy destuffer
(``golden.destuff_scan_host``); a compiler that is present but fails is an
error, not a reason to fall back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from .._build_dir import library_path

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "destuff.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_loaded = False


def _load() -> ctypes.CDLL | None:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    so_path = library_path("jpeggpu_host", [_SRC], _FLAGS)
    if not os.path.exists(so_path):
        tmp = f"{so_path}.tmp{os.getpid()}"
        subprocess.run([cxx, *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.jpeggpu_destuff_seg.restype = ctypes.c_int64
    lib.jpeggpu_destuff_seg.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32,
    ]
    lib.jpeggpu_bswap32.restype = None
    lib.jpeggpu_bswap32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
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
                  num_subseq: int, lanes: int, seg_raw: np.ndarray,
                  num_threads: int | None = None) -> np.ndarray | None:
    """Destuff straight into the padded device word layout.

    One native pass produces the uint32[lanes * 32] array the device bit
    reader consumes: segment-parallel destuff into the padded buffer plus an
    in-place big-endian word conversion. ``seg_raw`` is the parser's
    per-segment stuffed byte spans. Returns None if the machine has no C++
    compiler or the stream's segments do not fit their windows (the caller
    then takes the numpy destuffer, which clamps the same way).
    """
    lib = get_lib()
    if lib is None:
        return None
    if num_threads is None:
        num_threads = min(os.cpu_count() or 1, 8)
    body = np.ascontiguousarray(body, np.uint8)
    seg = np.ascontiguousarray(seg_sub_offset, np.int32)
    raw = np.ascontiguousarray(seg_raw, np.int64)
    full = np.zeros(lanes * 128, np.uint8)
    # capacity bound is the real subsequence count: a corrupt final segment
    # must not bleed into the zero padding the decode relies on
    rc = lib.jpeggpu_destuff_seg(
        body.ctypes.data, body.size, raw.ctypes.data, seg.ctypes.data,
        seg.size, full.ctypes.data, num_subseq * 128, num_threads)
    if rc < 0:
        return None
    words = full.view(np.uint32)
    lib.jpeggpu_bswap32(words.ctypes.data, num_subseq * 32, num_threads)
    return words
