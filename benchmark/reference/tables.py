"""Huffman decode-table derivation (host side).

Builds, from the DHT payload (16 code-length counts + value list), the
canonical-code decode arrays used by both the golden CPU decoder and the
device entropy decoder:

- ``maxcode[l]``: numerically largest code of length ``l+1`` (-1 if none),
- ``valptr_sub_mincode[l]``: ``valptr[l] - mincode[l]``, so that a matched
  code ``c`` of length ``l+1`` indexes ``huffval[valptr_sub_mincode[l]+c]``,
- ``huffval``: symbol values in canonical order, zero-padded to 256,
- an 8-bit prefix LUT (value, nbits) for short codes.

Same decode-table model as the reference (src/reader.cpp:186-224,
src/reader.hpp:45-64), re-derived from T.81 Annex C.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import HUFFMAN_ALPHABET_SIZE, MAX_HUFF_PER_SCAN
from .errors import InvalidJpeg

LOOKUP_BITS = 8


@dataclasses.dataclass
class HuffmanTable:
    """Decode tables for one Huffman table (DC or AC)."""

    # int32[16]; maxcode[l] is the largest code of length l+1, or -1
    maxcode: np.ndarray
    # int32[16]; valptr[l] - mincode[l]
    valptr_sub_mincode: np.ndarray
    # uint8[256]; values in canonical order (zero padded)
    huffval: np.ndarray
    # uint8[256] value and uint8[256] nbits for 8-bit prefixes (nbits=0: miss)
    lut_value: np.ndarray
    lut_nbits: np.ndarray
    # number of real symbols
    num_symbols: int = 0
    # True if the code space completes at some length (maxcode == 2^l - 1);
    # such tables (never emitted by practical encoders, T.81 K.2 reserves
    # the all-ones pattern) force the device decoder onto its
    # maxcode-comparison slow path for exactness.
    saturated: bool = False

    @staticmethod
    def empty() -> "HuffmanTable":
        return HuffmanTable(
            maxcode=np.full(16, -1, np.int32),
            valptr_sub_mincode=np.zeros(16, np.int32),
            huffval=np.zeros(HUFFMAN_ALPHABET_SIZE, np.uint8),
            lut_value=np.zeros(1 << LOOKUP_BITS, np.uint8),
            lut_nbits=np.zeros(1 << LOOKUP_BITS, np.uint8),
            num_symbols=0,
        )

    def copy(self) -> "HuffmanTable":
        return HuffmanTable(
            self.maxcode.copy(),
            self.valptr_sub_mincode.copy(),
            self.huffval.copy(),
            self.lut_value.copy(),
            self.lut_nbits.copy(),
            self.num_symbols,
            self.saturated,
        )


def build_huffman_table(num_codes: np.ndarray, values: np.ndarray) -> HuffmanTable:
    """Derive decode tables from DHT data.

    Args:
      num_codes: 16 counts; num_codes[l] symbols have codes of l+1 bits.
      values: the symbol values, canonical order (len == sum(num_codes)).
    """
    num_codes = np.asarray(num_codes, dtype=np.int64)
    values = np.asarray(values, dtype=np.uint8)
    total = int(num_codes.sum())
    if total != len(values):
        raise InvalidJpeg("DHT count mismatch")
    if total > HUFFMAN_ALPHABET_SIZE:
        raise InvalidJpeg("too many Huffman values")

    table = HuffmanTable.empty()
    table.huffval[:total] = values
    table.num_symbols = total

    # assign canonical codes: ascending length, ascending value order
    code = 0
    code_idx = 0
    codes = np.zeros(total, dtype=np.int64)
    for l in range(16):
        n = int(num_codes[l])
        if n:
            if code + n - 1 >= (1 << (l + 1)):
                raise InvalidJpeg("overfull Huffman code space")
            first = code_idx
            for _ in range(n):
                codes[code_idx] = code
                if l + 1 <= LOOKUP_BITS:
                    # fill LUT range [code << (8-(l+1)), +2^(8-(l+1)))
                    shift = LOOKUP_BITS - (l + 1)
                    lo = code << shift
                    hi = lo + (1 << shift)
                    table.lut_value[lo:hi] = table.huffval[code_idx]
                    table.lut_nbits[lo:hi] = l + 1
                code_idx += 1
                code += 1
            table.valptr_sub_mincode[l] = first - codes[first]
            table.maxcode[l] = codes[code_idx - 1]
            if table.maxcode[l] == (1 << (l + 1)) - 1:
                table.saturated = True
        code <<= 1
    return table


def pack_huffman_tables(tables) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A scan's Huffman tables, slot by slot, as the device takes them:
    int32 ``maxcode[8, 16]`` (-1 where a slot is empty), ``vsm[8, 16]``
    (``valptr_sub_mincode``) and ``huffval[8 * 256]``."""
    maxcode = np.full((MAX_HUFF_PER_SCAN, 16), -1, np.int32)
    vsm = np.zeros((MAX_HUFF_PER_SCAN, 16), np.int32)
    huffval = np.zeros((MAX_HUFF_PER_SCAN, 256), np.int32)
    for i, t in enumerate(tables):
        maxcode[i] = t.maxcode
        vsm[i] = t.valptr_sub_mincode
        huffval[i] = t.huffval
    return maxcode, vsm, huffval.reshape(-1)


def decode_category_scalar(table: HuffmanTable, bits32: int) -> tuple[int, int]:
    """Scalar canonical decode of one category symbol.

    ``bits32`` holds the next (up to) 32 bits MSB-aligned. Returns
    (value, length). The 8-bit prefix LUT resolves codes of <= 8 bits in one
    probe (the common case; reference reader.hpp:45-64 keeps the same LUT);
    longer or unmatched prefixes fall back to the canonical maxcode walk.
    Total-on-garbage: replicates the device clamping (index wrapped to
    uint8), cf. reference decode_huffman.cu:167-194.
    """
    probe = (bits32 >> (32 - LOOKUP_BITS)) & 0xFF
    nbits = int(table.lut_nbits[probe])
    if nbits:
        return int(table.lut_value[probe]), nbits
    for l in range(LOOKUP_BITS, 16):
        code = bits32 >> (31 - l)
        if code <= int(table.maxcode[l]) or l == 15:
            idx = (int(table.valptr_sub_mincode[l]) + code) & 0xFF
            return int(table.huffval[idx]), l + 1
    raise AssertionError("unreachable")


# --- standard Annex K tables (used by the bundled encoder) -----------------

STD_DC_LUMA = (
    np.array([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.uint8),
    np.arange(12, dtype=np.uint8),
)
STD_DC_CHROMA = (
    np.array([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.uint8),
    np.arange(12, dtype=np.uint8),
)
STD_AC_LUMA = (
    np.array([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], np.uint8),
    np.array([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
        0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
        0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
        0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
        0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
        0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
        0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
        0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
        0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
        0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
    ], np.uint8),
)
STD_AC_CHROMA = (
    np.array([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], np.uint8),
    np.array([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
        0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
        0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
        0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
        0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
        0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
        0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
        0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
        0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
        0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
        0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
        0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
        0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
    ], np.uint8),
)

# Annex K quantization tables (luma, chroma), natural (raster) order — the
# encoder divides raster-order DCT coefficients by these directly and only
# converts through ORDER_NATURAL when emitting the DQT segment
STD_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int32).reshape(8, 8)

STD_QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], np.int32).reshape(8, 8)
