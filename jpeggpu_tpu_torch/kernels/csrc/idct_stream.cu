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
// The 8-point pass, the level shift and the clamp live in idct_common.cuh,
// shared with K9 (idct_blocks.cu).

#include "idct_common.cuh"

namespace jpeggpu {

constexpr int kIdctBlock = 128;

__global__ void __launch_bounds__(kIdctBlock)
idct_stream_to_plane_kernel(const int16_t* __restrict__ coeffs,
                            const int16_t* __restrict__ dc,
                            const int32_t* __restrict__ qtable,
                            uint8_t* __restrict__ plane, int mcus_x,
                            int mcus_y, int du_per_mcu, int off, int ssx,
                            int ssy) {
  __shared__ uint32_t q[64];  // signed-int8 reading of the table bytes
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    q[i] = qvalue(qtable[i]);
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
  idct_block(v);

  const int64_t pitch = static_cast<int64_t>(blocks_x) * 8;
  uint8_t* dst = plane + (static_cast<int64_t>(by) * 8) * pitch + bx * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<uint2*>(dst + i * pitch) = pixel_row(v, i);
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
