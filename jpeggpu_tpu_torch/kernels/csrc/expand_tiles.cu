// K8: per-lane tiles -> the dense coefficient rows, third stage of the
// records write path in its per-lane shape (sparse scans).
//
// Replaces `jpeggpu_tpu/ops/write_pallas.py: expand_tiles` (kernel body
// `_expand_kernel`). Contract: output row j (one data unit, 64 int16 in
// natural order) belongs to group g = j / 128 and is the sum, with int16
// wrap, of the rows d = j - du0[l] of the tiles of the 64 candidate lanes l
// in [32 * q[g], 32 * q[g] + 64) for which 0 <= d < tile_d. A row shared by
// two lanes (a subsequence that ends inside a data unit) sums; the zero tile
// of an excluded lane matches and adds nothing. A candidate outside
// [0, lanes) contributes nothing, so the kernel never reads past the tiles
// whatever q holds. There is no DC side output in this shape.
//
// On the TPU this is a (128, 64 * tile_d) one-hot matrix times the two
// slabs' tiles. Here it is a gather: a block makes 32 rows of one group and
// stages the 64 candidates' du0 in shared memory; eight threads per output
// row, each owning 8 of its 64 columns, walk the candidates, load 16 bytes
// of every matching tile row, sum in int32 and store 16 bytes. A row's
// eight threads read one 128-byte line per match and write one.
//
// What bounds it on an H100: bytes. The function must read the matching
// tile rows once and write the rows once. On a sparse scan a lane's records
// span about a fifth of its tile, so most tile rows lie past every data
// unit the lane touches, yet each still matches the output row of its data
// unit (it is a row of zeros): nearly all of the tiles are read. `du0` and
// `q` come from L2.

#include <climits>

#include "tile_common.cuh"

namespace jpeggpu {

constexpr int kExpandTilesThreads = 256;
constexpr int kGroupDu = 128;   // output rows per group
constexpr int kSlab = 32;       // q counts slabs of 32 lanes
constexpr int kCandidates = 64;  // two slabs

static_assert(kGroupDu % (kExpandTilesThreads / 8) == 0,
              "the rows of a block share one group");

__global__ void __launch_bounds__(kExpandTilesThreads)
expand_tiles_kernel(const int16_t* __restrict__ tiles,
                    const int32_t* __restrict__ du0,
                    const int32_t* __restrict__ q, int16_t* __restrict__ rows,
                    int lanes, int tile_d, int n_rows) {
  // first data unit of each candidate lane; INT_MAX (no row can match:
  // j - INT_MAX < 0) for a candidate outside the lanes
  __shared__ int32_t first_du[kCandidates];
  const int row0 = blockIdx.x * (kExpandTilesThreads / 8);
  const long long lane0 = static_cast<long long>(q[row0 / kGroupDu]) * kSlab;
  if (threadIdx.x < kCandidates) {
    const long long l = lane0 + threadIdx.x;
    first_du[threadIdx.x] = (l >= 0 && l < lanes) ? du0[l] : INT_MAX;
  }
  __syncthreads();

  const int j = row0 + (threadIdx.x >> 3);  // output row
  const int c8 = threadIdx.x & 7;           // which 8 of its 64 columns
  if (j >= n_rows) return;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0, a5 = 0, a6 = 0, a7 = 0;
  for (int k = 0; k < kCandidates; ++k) {
    const long long d = static_cast<long long>(j) - first_du[k];
    if (d < 0 || d >= tile_d) continue;
    const size_t row = static_cast<size_t>(lane0 + k) * tile_d + static_cast<size_t>(d);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(tiles + row * 64) + c8);
    add_pair(v.x, a0, a1);
    add_pair(v.y, a2, a3);
    add_pair(v.z, a4, a5);
    add_pair(v.w, a6, a7);
  }
  uint4 out;
  out.x = pack_pair(a0, a1);
  out.y = pack_pair(a2, a3);
  out.z = pack_pair(a4, a5);
  out.w = pack_pair(a6, a7);
  reinterpret_cast<uint4*>(rows + static_cast<size_t>(j) * 64)[c8] = out;
}

}  // namespace jpeggpu

extern "C" int jpeggpu_expand_tiles(const void* tiles, const void* du0,
                                    const void* q, void* rows, int lanes,
                                    int tile_d, int n_rows, void* stream) {
  using namespace jpeggpu;
  if (n_rows <= 0) return 0;
  const int rows_per_block = kExpandTilesThreads / 8;
  const unsigned grid =
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block);
  expand_tiles_kernel<<<grid, kExpandTilesThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(tiles), static_cast<const int32_t*>(du0),
      static_cast<const int32_t*>(q), static_cast<int16_t*>(rows), lanes,
      tile_d, n_rows);
  return static_cast<int>(cudaGetLastError());
}
