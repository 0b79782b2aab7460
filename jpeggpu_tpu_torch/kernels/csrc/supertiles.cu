// K5: records of G consecutive lanes -> one natural-order (super_d, 64)
// supertile, second stage of the records write path.
//
// Replaces `jpeggpu_tpu/ops/write_pallas.py: supertiles_from_records`
// (kernel body `_supertiles_kernel`). Contract: row st of val_rows / pk_rows
// (int16, `sg` = S * G columns, column s * G + g = slot s of the group's
// lane g) holds the records of supertile st: pk = (d_rel << 6) | iz, the
// data-unit row within the supertile and the zig-zag index, or negative on
// an inert slot. Columns at and past mmax_st[st] * G are not read. Every
// other record with d_rel < super_d is added (int16 wrap) to
// tile[d_rel][natural[iz]]; the tile starts at zero and is written whole.
//
// On the TPU this is two one-hot matrix products per round, because that
// machine cannot scatter. A thread block can: one block per supertile keeps
// the tile in shared memory as int32, its threads walk the record columns
// with 16-byte loads and add each record to its cell with a shared-memory
// atomicAdd, and the tile leaves as int16 with 16-byte stores.
//
// Sum, not store: the reference's products sum the records of a cell, and
// a value-0 record (an EOB or ZRL run, or a symbol clamped at its segment's
// bound) can carry the position of a cell that another lane of the group
// really writes, so a plain store of it would destroy that value. Records
// of value 0 are skipped (adding them changes nothing). The nonzero records
// of a valid decode name distinct cells, since lanes own disjoint position
// ranges, but the kernel does not lean on that: with the atomicAdd it
// equals the plain version's index_add_ for any input, and shared-memory
// atomics on distinct addresses cost no more than stores.
//
// What bounds it on an H100: bytes. The records (2 x 2 bytes per slot, up
// to mmax_st slots of every lane) are read once and every supertile, zeros
// included, is written once: super_d * 128 bytes per G lanes.

#include "tile_common.cuh"

namespace jpeggpu {

constexpr int kSupertileThreads = 256;

__global__ void __launch_bounds__(kSupertileThreads)
supertiles_kernel(const int16_t* __restrict__ val_rows,
                  const int16_t* __restrict__ pk_rows,
                  const int32_t* __restrict__ mmax_st,
                  const int32_t* __restrict__ natural,
                  int16_t* __restrict__ out, int sg, int G, int super_d) {
  extern __shared__ int32_t tile[];  // super_d * 64
  __shared__ uint8_t nat[64];        // zig-zag index -> raster index
  const int st = blockIdx.x;
  const int cells = super_d * 64;
  tile_begin(tile, cells, nat, natural);

  long long want = static_cast<long long>(mmax_st[st]) * G;
  const int ncols = want <= 0 ? 0 : (want < sg ? static_cast<int>(want) : sg);
  const size_t row = static_cast<size_t>(st) * sg;  // sg % 8 == 0: aligned
  const uint4* pk8 = reinterpret_cast<const uint4*>(pk_rows + row);
  const uint4* val8 = reinterpret_cast<const uint4*>(val_rows + row);
  for (int i = threadIdx.x; i * 8 < ncols; i += blockDim.x) {
    const uint4 pw = __ldg(pk8 + i);
    const uint4 vw = __ldg(val8 + i);
    const uint32_t pws[4] = {pw.x, pw.y, pw.z, pw.w};
    const uint32_t vws[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int sh = (k & 1) * 16;
      const int pk = static_cast<int16_t>(pws[k >> 1] >> sh);
      const int val = static_cast<int16_t>(vws[k >> 1] >> sh);
      const int d = pk >> 6;
      if (i * 8 + k < ncols && pk >= 0 && val != 0 && d < super_d) {
        tile_place(tile, nat, d, pk & 63, val);
      }
    }
  }
  tile_store(tile, cells, out + static_cast<size_t>(st) * cells);
}

}  // namespace jpeggpu

extern "C" int jpeggpu_supertiles(const void* val_rows, const void* pk_rows,
                                  const void* mmax_st, const void* natural,
                                  void* out, int n_st, int sg, int G,
                                  int super_d, void* stream) {
  using namespace jpeggpu;
  if (n_st <= 0) return 0;
  const size_t shared = static_cast<size_t>(super_d) * 64 * sizeof(int32_t);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        supertiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  supertiles_kernel<<<n_st, kSupertileThreads, shared,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(val_rows),
      static_cast<const int16_t*>(pk_rows),
      static_cast<const int32_t*>(mmax_st),
      static_cast<const int32_t*>(natural), static_cast<int16_t*>(out), sg, G,
      super_d);
  return static_cast<int>(cudaGetLastError());
}
