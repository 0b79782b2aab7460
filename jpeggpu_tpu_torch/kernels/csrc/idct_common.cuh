// Shared device code of the two IDCT kernels (idct_stream.cu, K3;
// idct_blocks.cu, K9): the fixed-point 8-point pass of the AAN transform
// with the reference's rounding and int16 truncation, and the level shift
// and clamp of a pixel. Semantics follow jpeggpu_tpu_torch/idct_int.py
// statement for statement.
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

__device__ __forceinline__ uint32_t unfixh(uint32_t x) {
  return wrap16(sra(x + 0x8000u, 16));
}

// signed-int8 reading of a quantisation table byte (the reference's quirk)
__device__ __forceinline__ uint32_t qvalue(int32_t raw) {
  return static_cast<uint32_t>(((raw + 0x80) & 0xFF) - 0x80);
}

// 8-point transform in place over v[0], v[stride], ..., v[7 * stride]
template <int STRIDE>
__device__ __forceinline__ void idct8(uint32_t* v) {
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
  v[0] = unfixh(t20 + t50);
  v[STRIDE] = unfixh(t21 + t53);
  v[2 * STRIDE] = unfixh(t22 + t52);
  v[3 * STRIDE] = unfixh(t23 + t51);
  v[4 * STRIDE] = unfixh(t23 - t51);
  v[5 * STRIDE] = unfixh(t22 - t52);
  v[6 * STRIDE] = unfixh(t21 - t53);
  v[7 * STRIDE] = unfixh(t20 - t50);
}

// Dequantised block (64 values, raster order) -> pixels in place: the
// column pass, then the row pass.
__device__ __forceinline__ void idct_block(uint32_t* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) idct8<8>(v + j);  // down each column
#pragma unroll
  for (int i = 0; i < 8; ++i) idct8<1>(v + 8 * i);  // along each row
}

__device__ __forceinline__ uint32_t pixel(uint32_t x) {
  const int32_t s = static_cast<int32_t>(wrap16(x + 128u));
  return static_cast<uint32_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
}

// Pixel row i of a transformed block as 8 bytes, little-endian.
__device__ __forceinline__ uint2 pixel_row(const uint32_t* v, int i) {
  uint2 row;
  row.x = pixel(v[8 * i]) | (pixel(v[8 * i + 1]) << 8) |
          (pixel(v[8 * i + 2]) << 16) | (pixel(v[8 * i + 3]) << 24);
  row.y = pixel(v[8 * i + 4]) | (pixel(v[8 * i + 5]) << 8) |
          (pixel(v[8 * i + 6]) << 16) | (pixel(v[8 * i + 7]) << 24);
  return row;
}

}  // namespace jpeggpu
