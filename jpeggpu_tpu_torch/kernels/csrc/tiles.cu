// K7: the records of one lane -> its natural-order (tile_d, 64) tile, second
// stage of the records write path in its per-lane shape (sparse scans).
//
// Replaces `jpeggpu_tpu/ops/write_pallas.py: tiles_from_records` (kernel body
// `_tiles_kernel`). Contract: val (int16) and wpos (int32) are
// [s_cap, lanes], slot-major as the emission leaves them; wpos is the
// record's global stream position, negative on an inert slot. The record in
// slot s of lane l is live iff include[l], s < m[l], wpos >= 0 and
// d_rel = (wpos >> 6) - du0[l] lies in [0, tile_d); it is added (int16 wrap)
// to tile[l][d_rel][natural[wpos & 63]]. A lane with include false, or with
// no slot to read, gives an all-zero tile. Every tile is written whole.
//
// On the TPU this is a batched one-hot matrix product per round of 128
// slots, because that machine cannot scatter. A thread block can: one block
// per lane keeps the tile in shared memory as int32 (tile_d * 256 bytes, 32
// KB at tile_d 128), its threads walk the lane's slots and add each live
// record to its cell with a shared-memory atomicAdd, and the tile leaves as
// int16 with 16-byte stores. There is no padding of the slot axis to whole
// rounds: the loop ends at m[l].
//
// Sum in int32 and wrap, never store: a value-0 record (an EOB or ZRL run, or
// a symbol clamped at its segment's bound) can carry the position of a cell
// that the lane really writes, so a plain store of it would destroy that
// value. Records of value 0 are skipped (adding them changes nothing). The
// reference sums in float32 and casts to int16, which is the same number
// wherever the sum fits int16; two nonzero records on one cell cannot come
// from the decoder (a lane's positions strictly increase), so the two agree
// on every decoder output, and past that this kernel equals the plain
// version's index_add_ with int16 wrap for any input.
//
// What bounds it on an H100: bytes. The live records (6 bytes each) are read
// once and every tile, zeros included, is written once: tile_d * 128 bytes
// per lane. The records are read where they lie: one lane's column is
// strided by the lane count, so a warp's 32 loads touch 32 sectors of 32
// bytes, each of which also holds the same slot of the 7 (wpos) or 15 (val)
// neighbouring lanes. Blocks of neighbouring lanes run together and find
// those sectors in L2, so device memory sees each about once; the price is
// L2 traffic of 64 bytes per record, not a transposed copy of the buffer.

#include "tile_common.cuh"

namespace jpeggpu {

constexpr int kTileThreads = 256;

__global__ void __launch_bounds__(kTileThreads)
tiles_kernel(const int16_t* __restrict__ val, const int32_t* __restrict__ wpos,
             const int32_t* __restrict__ m, const int32_t* __restrict__ du0,
             const uint8_t* __restrict__ include,
             const int32_t* __restrict__ natural, int16_t* __restrict__ out,
             int s_cap, int lanes, int tile_d) {
  extern __shared__ int32_t tile[];  // tile_d * 64
  __shared__ uint8_t nat[64];        // zig-zag index -> raster index
  const int lane = blockIdx.x;
  const int cells = tile_d * 64;
  int16_t* mine = out + static_cast<size_t>(lane) * cells;

  int count = include[lane] ? m[lane] : 0;
  count = count < s_cap ? count : s_cap;
  if (count <= 0) {  // the same for every thread of the block
    uint4* out8 = reinterpret_cast<uint4*>(mine);
    for (int i = threadIdx.x; i < cells / 8; i += blockDim.x) {
      out8[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  tile_begin(tile, cells, nat, natural);

  const long long first_du = du0[lane];
  for (int s = threadIdx.x; s < count; s += blockDim.x) {
    const size_t at = static_cast<size_t>(s) * lanes + lane;
    const int w = __ldg(wpos + at);
    if (w < 0) continue;
    const long long d = static_cast<long long>(w >> 6) - first_du;
    if (d < 0 || d >= tile_d) continue;
    const int v = __ldg(val + at);
    if (v != 0) tile_place(tile, nat, static_cast<int>(d), w & 63, v);
  }
  tile_store(tile, cells, mine);
}

}  // namespace jpeggpu

extern "C" int jpeggpu_tiles(const void* val, const void* wpos, const void* m,
                             const void* du0, const void* include,
                             const void* natural, void* out, int s_cap,
                             int lanes, int tile_d, void* stream) {
  using namespace jpeggpu;
  if (lanes <= 0) return 0;
  const size_t shared = static_cast<size_t>(tile_d) * 64 * sizeof(int32_t);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tiles_kernel<<<lanes, kTileThreads, shared,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(val), static_cast<const int32_t*>(wpos),
      static_cast<const int32_t*>(m), static_cast<const int32_t*>(du0),
      static_cast<const uint8_t*>(include),
      static_cast<const int32_t*>(natural), static_cast<int16_t*>(out), s_cap,
      lanes, tile_d);
  return static_cast<int>(cudaGetLastError());
}
