// Shared device code of the two IDCT kernels (idct_stream.cu, K3;
// idct_blocks.cu, K9): the fixed-point 8-point pass of the AAN transform
// with the reference's rounding and int16 truncation, the level shift and
// clamp of a pixel, and the whole of one block from its eight coefficient
// rows to its eight pixel rows. Semantics follow
// jpeggpu_tpu_torch/idct_int.py; where a step is written differently (an
// int16 truncation that is the identity, the level shift folded into the
// row pass's rounding), the comment beside it says why the result is the
// same. The integer pipes bound both kernels about as much as the bytes
// do, so every such step saved counts.
//
// All arithmetic that can wrap on garbage input is unsigned; `>>` on the
// signed reinterpretation is arithmetic, as in the plain version.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jpeggpu {

constexpr uint32_t kCos14 = 0x5A82;
constexpr uint32_t kSin18 = 0x30FC;
constexpr uint32_t kCos18 = 0x7642;
constexpr uint32_t kOSin116 = 0x063E;
constexpr uint32_t kOSin516 = 0x1A9B;
constexpr uint32_t kOCos116 = 0x1F63;
constexpr uint32_t kOCos516 = 0x11C7;

__device__ __forceinline__ uint32_t sra(uint32_t x, int k) {
  return static_cast<uint32_t>(static_cast<int32_t>(x) >> k);
}

// truncate to int16 and sign-extend
__device__ __forceinline__ uint32_t wrap16(uint32_t x) {
  return static_cast<uint32_t>(
      static_cast<int32_t>(static_cast<int16_t>(x & 0xFFFFu)));
}

__device__ __forceinline__ uint32_t unfixo(uint32_t x) {
  return sra(x + 0x1000u, 13);
}

// sra by 16 of a 32-bit value already lies in the int16 range, so the
// reference's int16 truncation of this result is the identity
__device__ __forceinline__ uint32_t unfixh(uint32_t x) {
  return sra(x + 0x8000u, 16);
}

// signed-int8 reading of a quantisation table byte (the reference's quirk)
__device__ __forceinline__ uint32_t qvalue(int32_t raw) {
  return static_cast<uint32_t>(((raw + 0x80) & 0xFF) - 0x80);
}

// The 8-point pass over v[0], v[STRIDE], ..., v[7 * STRIDE]: its eight
// outputs before their rounding shift (output k is unfixh(o[k])).
template <int STRIDE>
__device__ __forceinline__ void idct8_sums(const uint32_t* v, uint32_t* o) {
  const uint32_t v0 = v[0], v1 = v[STRIDE], v2 = v[2 * STRIDE],
                 v3 = v[3 * STRIDE], v4 = v[4 * STRIDE], v5 = v[5 * STRIDE],
                 v6 = v[6 * STRIDE], v7 = v[7 * STRIDE];
  const uint32_t t10 = (v0 + v4) * kCos14;
  const uint32_t t11 = (v0 - v4) * kCos14;
  const uint32_t t12 = v2 * kSin18 - v6 * kCos18;
  const uint32_t t13 = v6 * kSin18 + v2 * kCos18;
  const uint32_t t20 = t10 + t13, t21 = t11 + t12;
  const uint32_t t22 = t11 - t12, t23 = t10 - t13;
  const uint32_t t30 = unfixo((v3 + v5) * kCos14);
  const uint32_t t31 = unfixo((v3 - v5) * kCos14);
  const uint32_t v1s = v1 << 2, v7s = v7 << 2;
  const uint32_t t40 = v1s + t30, t41 = v7s + t31;
  const uint32_t t42 = v1s - t30, t43 = v7s - t31;
  const uint32_t t50 = t40 * kOCos116 + t41 * kOSin116;
  const uint32_t t51 = t40 * kOSin116 - t41 * kOCos116;
  const uint32_t t52 = t42 * kOCos516 + t43 * kOSin516;
  const uint32_t t53 = t42 * kOSin516 - t43 * kOCos516;
  o[0] = t20 + t50;
  o[1] = t21 + t53;
  o[2] = t22 + t52;
  o[3] = t23 + t51;
  o[4] = t23 - t51;
  o[5] = t22 - t52;
  o[6] = t21 - t53;
  o[7] = t20 - t50;
}

// The level-shifted row-pass output, from the pass's sum before its
// rounding shift: wrap16(unfixh(x) + 128) == sra(x + 0x808000, 16), as both
// lie in the int16 range and agree mod 2^16, so the shift of 128 rides on
// the rounding bias. The pixel is this value clamped to 0..255.
__device__ __forceinline__ int32_t shifted(uint32_t x) {
  return static_cast<int32_t>(x + 0x808000u) >> 16;
}

// (c << 16) | (clamp(a, 0, 255) << 8) | clamp(b, 0, 255): one instruction
__device__ __forceinline__ uint32_t pack_sat_u8(int32_t a, int32_t b,
                                                uint32_t c) {
  uint32_t d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

// four pixels, p0 in the lowest byte
__device__ __forceinline__ uint32_t pack4(uint32_t p0, uint32_t p1,
                                          uint32_t p2, uint32_t p3) {
  return pack_sat_u8(shifted(p1), shifted(p0),
                     pack_sat_u8(shifted(p3), shifted(p2), 0));
}

// Dequantised block (64 values, raster order): the column pass in place,
// then the row pass of row i straight to its 8 pixels, little-endian.
__device__ __forceinline__ void idct_columns(uint32_t* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t o[8];
    idct8_sums<8>(v + j, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[8 * k + j] = unfixh(o[k]);
  }
}

__device__ __forceinline__ uint2 idct_row_pixels(const uint32_t* row) {
  uint32_t o[8];
  idct8_sums<1>(row, o);
  uint2 px;
  px.x = pack4(o[0], o[1], o[2], o[3]);
  px.y = pack4(o[4], o[5], o[6], o[7]);
  return px;
}

// The 64 coefficients of a block from its eight 16-byte rows (row-major
// int16). Only their low 16 bits are defined: the dequantisation wraps its
// product to int16, and the product's low 16 bits depend on nothing else.
__device__ __forceinline__ void unpack_rows(const int4 (&rows)[8],
                                            uint32_t* v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t parts[4] = {static_cast<uint32_t>(rows[k].x),
                               static_cast<uint32_t>(rows[k].y),
                               static_cast<uint32_t>(rows[k].z),
                               static_cast<uint32_t>(rows[k].w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * k + 2 * j] = parts[j];
      v[8 * k + 2 * j + 1] = parts[j] >> 16;
    }
  }
}

// Dequantise by `q` (the table's 64 signed-int8 readings, 16-byte aligned,
// in shared memory), transform, and store the block's eight pixel rows of
// 8 bytes at `dst`, `pitch` bytes apart.
__device__ __forceinline__ void dequant_idct_store(uint32_t* v,
                                                   const uint32_t* q,
                                                   uint8_t* dst,
                                                   int64_t pitch) {
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint4 t = q4[j];
    v[4 * j] = wrap16(v[4 * j] * t.x);
    v[4 * j + 1] = wrap16(v[4 * j + 1] * t.y);
    v[4 * j + 2] = wrap16(v[4 * j + 2] * t.z);
    v[4 * j + 3] = wrap16(v[4 * j + 3] * t.w);
  }
  idct_columns(v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<uint2*>(dst + i * pitch) = idct_row_pixels(v + 8 * i);
  }
}

}  // namespace jpeggpu
