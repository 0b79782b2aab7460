// K8: per-lane tiles -> the dense coefficient rows, third stage of the
// records write path in its per-lane shape (sparse scans).
//
// Replaces `jpeggpu_tpu/ops/write_pallas.py: expand_tiles` (kernel body
// `_expand_kernel`). Contract: output row j (one data unit, 64 int16 in
// natural order) belongs to group g = j / 128 and is the sum, with int16
// wrap, of the rows d = j - du0[l] of the tiles of the 64 candidate lanes l
// in [32 * q[g], 32 * q[g] + 64) for which 0 <= d < tile_d and, where
// `reach` is given, j <= reach[l]. A row shared by two lanes (a subsequence
// that ends inside a data unit) sums; the zero tile of an excluded lane
// adds nothing. A candidate outside [0, lanes) contributes nothing, so the
// kernel never reads past the tiles whatever q holds; du0 and reach may
// hold any int32 (unsorted, negative, INT_MIN, INT_MAX). There is no DC
// side output in this shape.
//
// `reach` (ops/write.py assemble_tiles): the last data unit whose tile row
// can be nonzero, max_du of the lane's records, -1 for a leftover lane. K7
// places a record only at d_rel = (wpos >> 6) - du0 <= max_du - du0 and
// writes zeros everywhere else, and a leftover lane's tile is all zeros, so
// the rows past reach add nothing and the output is the same with or
// without it. Without it every tile row that matches an output row is read.
//
// On the TPU this is a (128, 64 * tile_d) one-hot matrix times the two
// slabs' tiles. Here it is a gather. A block makes 32 rows of one group with
// eight threads per row, each owning 8 of its 64 columns (16 bytes). The
// block stages the window of each of the 64 candidates, [du0, min(du0 +
// tile_d - 1, reach)], in shared memory. Each thread of a row tests 8 of the
// 64 candidates (thread c the candidates 8 i + c: the eight threads read 64
// neighbouring bytes), and 8 warp votes give every thread of the row the
// 64-bit mask of its hits. Then each thread loads 16 bytes of two hit rows
// at a time, both loads issued before the first add, sums in int32 and
// stores 16 bytes. A row's eight threads read one 128-byte line per hit and
// write one. Two, because with reach nearly every row has one hit and at
// the full depth about two: batches of four spent their predicated empty
// slots' instructions for nothing, and two or four rows per thread (the
// window staged once for more rows, more loads in flight) helped with reach
// and hurt at the full depth, in variants timed on an H100.
//
// What bounds it on an H100: bytes. The function must read the tile rows
// that can be nonzero once and write the rows once. On a sparse scan a
// lane's records span about a fifth of its tile: with reach, about one
// tile row per output row is read (plus the rows two lanes share); without
// it, every matching row, nearly all of the tiles. The candidate test is 64
// compare pairs per row, shared by its eight threads, where each thread
// once walked all 64 candidates (a subtract, two compares and a branch each,
// ~1.6 G instructions at 12 MP, quality 30). `du0`, `reach` and `q` come
// from L2.

#include <climits>

#include "tile_common.cuh"

namespace jpeggpu {

constexpr int kExpandTilesThreads = 256;
constexpr int kGroupDu = 128;   // output rows per group
constexpr int kSlab = 32;       // q counts slabs of 32 lanes
constexpr int kCandidates = 64;  // two slabs
constexpr int kBatch = 2;       // hit rows loaded before their adds

static_assert(kGroupDu % (kExpandTilesThreads / 8) == 0,
              "the rows of a block share one group");
static_assert(kCandidates == 8 * 8, "eight threads test eight each");

__global__ void __launch_bounds__(kExpandTilesThreads)
expand_tiles_kernel(const int16_t* __restrict__ tiles,
                    const int32_t* __restrict__ du0,
                    const int32_t* __restrict__ reach,
                    const int32_t* __restrict__ q, int16_t* __restrict__ rows,
                    int lanes, int tile_d, int n_rows) {
  // the output rows each candidate lane can add to, [x, y]; empty (x
  // INT_MAX, y INT_MIN) for a candidate outside the lanes
  __shared__ int2 window[kCandidates];
  const int row0 = blockIdx.x * (kExpandTilesThreads / 8);
  const long long lane0 = static_cast<long long>(q[row0 / kGroupDu]) * kSlab;
  if (threadIdx.x < kCandidates) {
    const long long l = lane0 + threadIdx.x;
    int2 w = make_int2(INT_MAX, INT_MIN);
    if (l >= 0 && l < lanes) {
      const int first = du0[l];
      long long last = static_cast<long long>(first) + tile_d - 1;
      if (reach != nullptr && reach[l] < last) last = reach[l];
      w = make_int2(first, last < INT_MAX ? static_cast<int>(last) : INT_MAX);
    }
    window[threadIdx.x] = w;
  }
  __syncthreads();

  const int j = row0 + (threadIdx.x >> 3);  // output row
  const int c8 = threadIdx.x & 7;           // which 8 of its 64 columns
  const int shift = threadIdx.x & 24;       // the row's byte of a warp vote
  // hits: bit k set iff candidate k adds its row to row j; the warp is
  // whole here (the votes need all 32 threads)
  uint64_t hits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int2 w = window[8 * i + c8];
    const unsigned vote = __ballot_sync(0xFFFFFFFFu, j >= w.x && j <= w.y);
    hits |= static_cast<uint64_t>((vote >> shift) & 0xFFu) << (8 * i);
  }
  if (j >= n_rows) return;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0, a5 = 0, a6 = 0, a7 = 0;
  while (hits != 0) {
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      v[b] = make_uint4(0u, 0u, 0u, 0u);
      if (hits != 0) {
        const int k = __ffsll(static_cast<long long>(hits)) - 1;
        hits &= hits - 1;
        // j - x < tile_d for a hit
        const size_t row = static_cast<size_t>(lane0 + k) * tile_d +
                           static_cast<size_t>(j - window[k].x);
        v[b] = __ldg(reinterpret_cast<const uint4*>(tiles + row * 64) + c8);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      add_pair(v[b].x, a0, a1);
      add_pair(v[b].y, a2, a3);
      add_pair(v[b].z, a4, a5);
      add_pair(v[b].w, a6, a7);
    }
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
                                    const void* reach, const void* q,
                                    void* rows, int lanes, int tile_d,
                                    int n_rows, void* stream) {
  using namespace jpeggpu;
  if (n_rows <= 0) return 0;
  const int rows_per_block = kExpandTilesThreads / 8;
  const unsigned grid =
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block);
  expand_tiles_kernel<<<grid, kExpandTilesThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(tiles), static_cast<const int32_t*>(du0),
      static_cast<const int32_t*>(reach), static_cast<const int32_t*>(q),
      static_cast<int16_t*>(rows), lanes, tile_d, n_rows);
  return static_cast<int>(cudaGetLastError());
}
