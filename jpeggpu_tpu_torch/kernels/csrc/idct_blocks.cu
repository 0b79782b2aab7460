// K9: an int16 coefficient plane -> its uint8 pixel plane, 8x8 block by
// 8x8 block: dequantise (table bytes read as signed int8, product wrapped
// to int16), column and row pass of the fixed-point AAN transform (every
// pass result wrapped to int16), add 128, clamp to 0..255.
//
// Replaces the Pallas kernel `_idct_kernel` behind
// `jpeggpu_tpu/ops/idct_pallas.py: dequant_idct_blocks_pallas`, together
// with the transposes of its caller `jpeggpu_tpu/ops/idct.py:
// dequant_idct_plane` (plane -> int32 (N, 8, 8) blocks -> plane), which
// fold into this kernel's addressing. The TPU kernel takes int32 blocks;
// reading the int16 plane loses nothing, since the dequantisation wraps
// mod 2^16 either way. On the card it runs in the sharded decode's row-chunk
// tail (`parallel/segments.py`), once per component per shard, after the
// chunk's de-interleave.
//
// What bounds it on an H100: bytes. Each coefficient is read once (2 B) and
// each pixel written once (1 B) against ~25 integer operations per pixel,
// as in K3 (idct_stream.cu, whose device code it shares through
// idct_common.cuh). So every byte moves once and in wide accesses: one
// thread owns one 8x8 block, reads its eight 16-byte block rows, keeps the
// 64 values in registers through both passes and stores eight 8-byte pixel
// rows. Neighbouring threads own neighbouring blocks of one block row, so
// a warp's loads of one coefficient row are one contiguous 512-byte run and
// its stores of one pixel row one contiguous 256-byte run.

#include "idct_common.cuh"

namespace jpeggpu {

constexpr int kIdctBlocksPerCta = 128;

__global__ void __launch_bounds__(kIdctBlocksPerCta)
dequant_idct_plane_kernel(const int16_t* __restrict__ coeffs,
                          const int32_t* __restrict__ qtable,
                          uint8_t* __restrict__ out, int height, int width) {
  __shared__ uint32_t q[64];  // signed-int8 reading of the table bytes
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    q[i] = qvalue(qtable[i]);
  }
  __syncthreads();

  const int blocks_x = width >> 3;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= blocks_x * (height >> 3)) return;
  const int by = idx / blocks_x;
  const int bx = idx - by * blocks_x;
  const int64_t origin = static_cast<int64_t>(by) * 8 * width + bx * 8;

  uint32_t v[64];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int4 w =
        __ldg(reinterpret_cast<const int4*>(coeffs + origin + i * width));
    const int32_t parts[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = wrap16(static_cast<uint32_t>(parts[j]));
      v[8 * i + 2 * j + 1] = sra(static_cast<uint32_t>(parts[j]), 16);
    }
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = wrap16(v[i] * q[i]);
  idct_block(v);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<uint2*>(out + origin + i * width) = pixel_row(v, i);
  }
}

}  // namespace jpeggpu

extern "C" int jpeggpu_dequant_idct_plane(const void* coeffs,
                                          const void* qtable, void* out,
                                          int height, int width,
                                          void* stream) {
  using namespace jpeggpu;
  const int blocks = (height / 8) * (width / 8);
  if (blocks == 0) return 0;
  const dim3 block(kIdctBlocksPerCta);
  const dim3 grid((blocks + kIdctBlocksPerCta - 1) / kIdctBlocksPerCta);
  dequant_idct_plane_kernel<<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coeffs),
      static_cast<const int32_t*>(qtable), static_cast<uint8_t*>(out),
      height, width);
  return static_cast<int>(cudaGetLastError());
}
