// K3: stream-order coefficients of one component -> its uint8 pixel plane.
//
// Replaces the Pallas kernel `_stream_idct_kernel` behind
// `jpeggpu_tpu/ops/idct_pallas.py: idct_stream_to_plane`. One launch per
// component does the de-interleave (it reads the component's data units
// where the MCU-interleaved stream has them), splices the un-deltaed DC
// from the side vector into slot 0, dequantises with the table bytes read
// as signed int8 and the product wrapped to int16, runs the column and the
// row pass of the fixed-point AAN transform (every pass result wrapped to
// int16), adds 128, clamps and stores 8x8 pixels at the plane's pitch.
//
// What bounds it on an H100: bytes. Each coefficient is read once (2 B)
// and each pixel written once (1 B), against ~40 integer operations per
// pixel: 3 bytes per pixel at 3.35 TB/s is reached long before the ALUs
// are. The design therefore moves every byte once and in wide accesses:
// one thread owns one data unit, reads its 128 contiguous bytes as eight
// 16-byte loads, keeps all 64 values in registers through both passes (no
// shared memory, no intermediate in device memory) and stores eight 8-byte
// rows; consecutive threads own horizontally adjacent blocks of the plane,
// so a warp's stores of one pixel row are one contiguous 256-byte run.
// The TPU kernel's lo/hi int32 byte packing has no counterpart here.
//
// All arithmetic that can wrap on garbage input is unsigned; `>>` on the
// signed reinterpretation is arithmetic, as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace jpeggpu {

constexpr int kIdctBlock = 128;

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

__device__ __forceinline__ uint32_t pixel(uint32_t x) {
  const int32_t s = static_cast<int32_t>(wrap16(x + 128u));
  return static_cast<uint32_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
}

__global__ void __launch_bounds__(kIdctBlock)
idct_stream_to_plane_kernel(const int16_t* __restrict__ coeffs,
                            const int16_t* __restrict__ dc,
                            const int32_t* __restrict__ qtable,
                            uint8_t* __restrict__ plane, int mcus_x,
                            int mcus_y, int du_per_mcu, int off, int ssx,
                            int ssy) {
  __shared__ uint32_t q[64];  // signed-int8 reading of the table bytes
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    const int32_t raw = qtable[i];
    q[i] = static_cast<uint32_t>(((raw + 0x80) & 0xFF) - 0x80);
  }
  __syncthreads();

  const int blocks_x = mcus_x * ssx;
  const int blocks_y = mcus_y * ssy;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= blocks_x * blocks_y) return;
  const int by = idx / blocks_x;
  const int bx = idx - by * blocks_x;
  const int my = by / ssy, sy = by - my * ssy;
  const int mxi = bx / ssx, sx = bx - mxi * ssx;
  const int64_t du =
      static_cast<int64_t>(my * mcus_x + mxi) * du_per_mcu + off + sy * ssx + sx;

  uint32_t v[64];
  const int4* src = reinterpret_cast<const int4*>(coeffs + du * 64);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int4 w = __ldg(src + k);
    const int32_t parts[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * k + 2 * j] = wrap16(static_cast<uint32_t>(parts[j]));
      v[8 * k + 2 * j + 1] = sra(static_cast<uint32_t>(parts[j]), 16);
    }
  }
  v[0] = static_cast<uint32_t>(static_cast<int32_t>(dc[du]));
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = wrap16(v[i] * q[i]);
#pragma unroll
  for (int j = 0; j < 8; ++j) idct8<8>(v + j);  // down each column
#pragma unroll
  for (int i = 0; i < 8; ++i) idct8<1>(v + 8 * i);  // along each row

  const int64_t pitch = static_cast<int64_t>(blocks_x) * 8;
  uint8_t* dst = plane + (static_cast<int64_t>(by) * 8) * pitch + bx * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint2 row;
    row.x = pixel(v[8 * i]) | (pixel(v[8 * i + 1]) << 8) |
            (pixel(v[8 * i + 2]) << 16) | (pixel(v[8 * i + 3]) << 24);
    row.y = pixel(v[8 * i + 4]) | (pixel(v[8 * i + 5]) << 8) |
            (pixel(v[8 * i + 6]) << 16) | (pixel(v[8 * i + 7]) << 24);
    *reinterpret_cast<uint2*>(dst + i * pitch) = row;
  }
}

}  // namespace jpeggpu

extern "C" int jpeggpu_idct_stream_to_plane(
    const void* coeffs, const void* dc, const void* qtable, void* plane,
    int mcus_x, int mcus_y, int du_per_mcu, int off, int ssx, int ssy,
    void* stream) {
  using namespace jpeggpu;
  const int units = mcus_x * ssx * mcus_y * ssy;
  const dim3 block(kIdctBlock);
  const dim3 grid((units + kIdctBlock - 1) / kIdctBlock);
  idct_stream_to_plane_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coeffs), static_cast<const int16_t*>(dc),
      static_cast<const int32_t*>(qtable), static_cast<uint8_t*>(plane),
      mcus_x, mcus_y, du_per_mcu, off, ssx, ssy);
  return static_cast<int>(cudaGetLastError());
}
