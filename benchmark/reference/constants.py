"""Shared constants of the baseline-JPEG codec.

Mirrors the semantics of the reference constants (see the
reference's src/defs.hpp:67-103, src/decoder_defs.hpp:27-36 and
src/marker.hpp:29-102) without copying code: these values are fixed by
ITU-T T.81 and by the subsequence-parallel decode scheme of
"Accelerating JPEG Decompression on GPUs" (arXiv:2111.09219).
"""

from __future__ import annotations

import numpy as np

# --- geometry -------------------------------------------------------------
DATA_UNIT_DIM = 8  # rows/cols in an 8x8 block   (defs.hpp:71)
DATA_UNIT_SIZE = 64  # coefficients per block      (defs.hpp:73)
MAX_COMPONENTS = 4  # supported component count   (defs.hpp:76)
MAX_SCANS = 4  # baseline: each scan holds >=1 whole component (defs.hpp:79)
HUFFMAN_ALPHABET_SIZE = 256

# huffman classes; a scan can reference up to 4 DC + 4 AC tables
HUFF_DC = 0
HUFF_AC = 1
HUFF_COUNT = 2
MAX_HUFF_PER_SCAN = MAX_COMPONENTS * HUFF_COUNT  # 8, layout [dc0,ac0,dc1,ac1,...]

# --- subsequence-parallel decode scheme -----------------------------------
# "s" in the paper: subsequence size in 32-bit words (decoder_defs.hpp:32)
CHUNK_SIZE_WORDS = 32
SUBSEQ_SIZE_BYTES = CHUNK_SIZE_WORDS * 4  # 128 bytes
SUBSEQ_SIZE_BITS = CHUNK_SIZE_WORDS * 32  # 1024 bits
# bit offsets (lanes x 1024) and output positions are int32 on the device:
# one decode's stay at or below this (ops.huffman.make_ctx and the write
# stage raise past it; parallel.batch splits a larger merged group)
I32_MAX = 2 ** 31 - 1

# --- zig-zag order ---------------------------------------------------------
# ORDER_NATURAL[i] = raster index of zig-zag index i (T.81 Figure A.6;
# defs.hpp:94-102). Derived programmatically rather than transcribed.


def _zigzag_to_natural() -> np.ndarray:
    order = np.empty(64, dtype=np.int32)
    x = y = 0
    up = True
    for i in range(64):
        order[i] = y * 8 + x
        if up:
            if x == 7:
                y += 1
                up = False
            elif y == 0:
                x += 1
                up = False
            else:
                x += 1
                y -= 1
        else:
            if y == 7:
                x += 1
                up = True
            elif x == 0:
                y += 1
                up = True
            else:
                x -= 1
                y += 1
    return order


ORDER_NATURAL = _zigzag_to_natural()
ORDER_NATURAL.setflags(write=False)

# raster index -> zig-zag index (inverse permutation)
ORDER_ZIGZAG = np.argsort(ORDER_NATURAL).astype(np.int32)
ORDER_ZIGZAG.setflags(write=False)

# --- markers (T.81 Table B.1) ----------------------------------------------
MARKER_SOF0 = 0xC0
MARKER_SOF1 = 0xC1
MARKER_SOF2 = 0xC2
MARKER_SOF3 = 0xC3
MARKER_DHT = 0xC4
MARKER_SOF5 = 0xC5
MARKER_SOF6 = 0xC6
MARKER_SOF7 = 0xC7
MARKER_JPG = 0xC8
MARKER_SOF9 = 0xC9
MARKER_SOF10 = 0xCA
MARKER_SOF11 = 0xCB
MARKER_DAC = 0xCC
MARKER_SOF13 = 0xCD
MARKER_SOF14 = 0xCE
MARKER_SOF15 = 0xCF
MARKER_RST0 = 0xD0
MARKER_RST7 = 0xD7
MARKER_SOI = 0xD8
MARKER_EOI = 0xD9
MARKER_SOS = 0xDA
MARKER_DQT = 0xDB
MARKER_DNL = 0xDC
MARKER_DRI = 0xDD
MARKER_DHP = 0xDE
MARKER_EXP = 0xDF
MARKER_APP0 = 0xE0
MARKER_APP15 = 0xEF
MARKER_COM = 0xFE
MARKER_TEM = 0x01

_UNSUPPORTED_SOFS = {
    MARKER_SOF2, MARKER_SOF3, MARKER_SOF5, MARKER_SOF6, MARKER_SOF7,
    MARKER_SOF9, MARKER_SOF10, MARKER_SOF11, MARKER_SOF13, MARKER_SOF14,
    MARKER_SOF15,
}

_MARKER_NAMES = {
    MARKER_SOF0: "SOF0", MARKER_SOF1: "SOF1", MARKER_SOF2: "SOF2",
    MARKER_SOF3: "SOF3", MARKER_DHT: "DHT", MARKER_SOF5: "SOF5",
    MARKER_SOF6: "SOF6", MARKER_SOF7: "SOF7", MARKER_JPG: "JPG",
    MARKER_SOF9: "SOF9", MARKER_SOF10: "SOF10", MARKER_SOF11: "SOF11",
    MARKER_DAC: "DAC", MARKER_SOF13: "SOF13", MARKER_SOF14: "SOF14",
    MARKER_SOF15: "SOF15", MARKER_SOI: "SOI", MARKER_EOI: "EOI",
    MARKER_SOS: "SOS", MARKER_DQT: "DQT", MARKER_DNL: "DNL",
    MARKER_DRI: "DRI", MARKER_DHP: "DHP", MARKER_EXP: "EXP",
    MARKER_COM: "COM", MARKER_TEM: "TEM",
}


def is_rst(marker: int) -> bool:
    return MARKER_RST0 <= marker <= MARKER_RST7


def marker_name(marker: int) -> str:
    if MARKER_RST0 <= marker <= MARKER_RST7:
        return f"RST{marker - MARKER_RST0}"
    if MARKER_APP0 <= marker <= MARKER_APP15:
        return f"APP{marker - MARKER_APP0}"
    return _MARKER_NAMES.get(marker, f"0x{marker:02x}")
