// Device routines shared by the tile kernels of the records write path:
// K5 / K7 keep a tile as int32 in shared memory and place records into it,
// K6 / K8 gather-sum int16 tile rows 16 bytes at a time.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jpeggpu {

// Two int16 values of one 32-bit word, added to two int32 sums.
__device__ inline void add_pair(uint32_t w, int& lo, int& hi) {
  lo += static_cast<int16_t>(w & 0xFFFFu);
  hi += static_cast<int16_t>(w >> 16);
}

// Two int32 sums, wrapped to int16, as one 32-bit word.
__device__ inline uint32_t pack_pair(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xFFFFu) | (static_cast<uint32_t>(hi) << 16);
}

// Zero a block's shared-memory tile of `cells` int32 and load the zig-zag ->
// raster table into `nat`; ends in a barrier.
__device__ inline void tile_begin(int32_t* tile, int cells, uint8_t* nat,
                                  const int32_t* __restrict__ natural) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) tile[i] = 0;
  if (threadIdx.x < 64) {
    nat[threadIdx.x] = static_cast<uint8_t>(natural[threadIdx.x]);
  }
  __syncthreads();
}

// One record into the tile: sum, never store (see the callers' headers).
__device__ inline void tile_place(int32_t* tile, const uint8_t* nat, int d,
                                  int iz, int val) {
  atomicAdd(&tile[d * 64 + nat[iz]], val);
}

// After a barrier, write the tile (cells % 8 == 0) to `out` as int16 with
// 16-byte stores; `out` is 16-byte aligned.
__device__ inline void tile_store(const int32_t* tile, int cells,
                                  int16_t* __restrict__ out) {
  __syncthreads();
  uint4* out8 = reinterpret_cast<uint4*>(out);
  for (int i = threadIdx.x; i < cells / 8; i += blockDim.x) {
    const int32_t* t = tile + i * 8;
    uint4 w;
    w.x = pack_pair(t[0], t[1]);
    w.y = pack_pair(t[2], t[3]);
    w.z = pack_pair(t[4], t[5]);
    w.w = pack_pair(t[6], t[7]);
    out8[i] = w;
  }
}

}  // namespace jpeggpu
