"""Integer fixed-point 8x8 dequantize + IDCT, array-namespace generic.

Implements the AAN-style fixed-point IDCT of the NVIDIA dct8x8 whitepaper
with the exact rounding/truncation semantics of the reference device kernel
(src/idct.cu:44-95, 146-223):

- dequantization multiplies the int16 coefficient with the quantization
  value read as *signed* int8 and truncates the product to int16
  (idct.cu:179-181),
- a column pass then a row pass of the same 8-point transform, each pass
  storing its results truncated to int16 (idct.cu:98-144),
- ``unfixo(x) = (x + 0x1000) >> 13`` (arithmetic), ``unfixh(x) = int16((x +
  0x8000) >> 16)`` (idct.cu:44-47),
- final ``int16(x + 128)`` level shift then clamp to [0, 255].

The function is written against a generic array namespace ``xp`` so the
identical arithmetic is used by the numpy golden decoder and the torch
plain version of the device tail — bit-exactness between the two is tested, not hoped for.
"""

from __future__ import annotations

# fixed-point constants (Q15/Q13 representations of the AAN rotation factors)
_COS_1_4 = 0x5A82
_SIN_1_8 = 0x30FC
_COS_1_8 = 0x7642
_OSIN_1_16 = 0x063E
_OSIN_5_16 = 0x1A9B
_OCOS_1_16 = 0x1F63
_OCOS_5_16 = 0x11C7


def _wrap_i16(xp, x):
    """Truncate int32 values to int16 with wraparound, staying in int32."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _unfixo(x):
    return (x + 0x1000) >> 13


def _unfixh(xp, x):
    return _wrap_i16(xp, (x + 0x8000) >> 16)


def _idct_vector(xp, v):
    """8-point transform over a list of 8 int32 arrays; returns 8 arrays
    already truncated to int16 range."""
    v0, v1, v2, v3, v4, v5, v6, v7 = v

    tmp10 = (v0 + v4) * _COS_1_4
    tmp11 = (v0 - v4) * _COS_1_4
    tmp12 = v2 * _SIN_1_8 - v6 * _COS_1_8
    tmp13 = v6 * _SIN_1_8 + v2 * _COS_1_8

    tmp20 = tmp10 + tmp13
    tmp21 = tmp11 + tmp12
    tmp22 = tmp11 - tmp12
    tmp23 = tmp10 - tmp13

    tmp30 = _unfixo((v3 + v5) * _COS_1_4)
    tmp31 = _unfixo((v3 - v5) * _COS_1_4)

    v1s = v1 << 2
    v7s = v7 << 2

    tmp40 = v1s + tmp30
    tmp41 = v7s + tmp31
    tmp42 = v1s - tmp30
    tmp43 = v7s - tmp31

    tmp50 = tmp40 * _OCOS_1_16 + tmp41 * _OSIN_1_16
    tmp51 = tmp40 * _OSIN_1_16 - tmp41 * _OCOS_1_16
    tmp52 = tmp42 * _OCOS_5_16 + tmp43 * _OSIN_5_16
    tmp53 = tmp42 * _OSIN_5_16 - tmp43 * _OCOS_5_16

    return (
        _unfixh(xp, tmp20 + tmp50),
        _unfixh(xp, tmp21 + tmp53),
        _unfixh(xp, tmp22 + tmp52),
        _unfixh(xp, tmp23 + tmp51),
        _unfixh(xp, tmp23 - tmp51),
        _unfixh(xp, tmp22 - tmp52),
        _unfixh(xp, tmp21 - tmp53),
        _unfixh(xp, tmp20 - tmp50),
    )


def dequant_idct_blocks(xp, coeffs, qtable):
    """Dequantize + IDCT a batch of blocks.

    Args:
      xp: array namespace (numpy or torch).
      coeffs: int32 array (..., 8, 8), natural (raster) order, int16-range.
      qtable: int32 array (64,) or (8, 8), natural order; values are the raw
        DQT bytes and are interpreted as *signed* int8 like the reference.

    Returns:
      int32 array (..., 8, 8) of pixel values in [0, 255].
    """
    q = qtable.reshape(8, 8)
    # signed-int8 reinterpretation of the quantization bytes (idct.cu:179)
    q = ((q + 0x80) & 0xFF) - 0x80
    dq = _wrap_i16(xp, coeffs * q)

    # column pass: transform along the row axis (each column independently)
    cols = _idct_vector(xp, [dq[..., i, :] for i in range(8)])
    inter = xp.stack(cols, -2)
    # row pass: transform along the column axis
    rows = _idct_vector(xp, [inter[..., :, i] for i in range(8)])
    out = xp.stack(rows, -1)

    out = _wrap_i16(xp, out + 128)
    return xp.clip(out, 0, 255)
