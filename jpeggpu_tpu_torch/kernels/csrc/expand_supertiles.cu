// K6: supertiles -> the dense coefficient rows and the DC side vector,
// third stage of the records write path.
//
// Replaces `jpeggpu_tpu/ops/write_pallas.py: expand_supertiles` (kernel body
// `_expand_super_kernel`). Contract: output row j (one data unit, 64 int16
// in natural order) belongs to group g = j / group_du and is the sum, with
// int16 wrap, of the rows d = j - base[st] of the supertiles st in
// q[g] .. q[g] + W - 1 for which 0 <= d < super_d. Rows shared by two
// supertiles (a lane group that ends inside a data unit) sum. A window
// position outside [0, n_st) contributes nothing, so the kernel never reads
// past the supertiles whatever q holds. dc[j] is column 0 of row j.
//
// On the TPU this is a (group_du, W * super_d) one-hot matrix times the
// window's tiles. Here it is a gather: eight threads per output row, each
// owning 8 of its 64 columns, walk the window, load 16 bytes of every
// matching supertile row, sum in int32 and store 16 bytes. A row's eight
// threads read one 128-byte line per match and write one.
//
// What bounds it on an H100: bytes. The function must read the supertiles
// once and write the rows once. The kernel reads only matching rows, but
// every row of a supertile inside some window matches (zero rows past the
// lanes' span included), so it reads nearly all of them; `base` and `q`
// come from L2.

#include "tile_common.cuh"

namespace jpeggpu {

constexpr int kExpandThreads = 256;

__global__ void __launch_bounds__(kExpandThreads)
expand_supertiles_kernel(const int16_t* __restrict__ stiles,
                         const int32_t* __restrict__ base,
                         const int32_t* __restrict__ q,
                         int16_t* __restrict__ rows, int16_t* __restrict__ dc,
                         int n_st, int super_d, int W, int group_du,
                         int n_rows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = t >> 3;  // output row
  const int c8 = t & 7;  // which 8 of its 64 columns
  if (j >= n_rows) return;
  const int q0 = q[j / group_du];
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0, a4 = 0, a5 = 0, a6 = 0, a7 = 0;
  for (int k = 0; k < W; ++k) {
    const int st = q0 + k;
    if (st < 0 || st >= n_st) continue;
    const long long d = static_cast<long long>(j) - base[st];
    if (d < 0 || d >= super_d) continue;
    const size_t row = static_cast<size_t>(st) * super_d + static_cast<size_t>(d);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(stiles + row * 64) + c8);
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
  if (c8 == 0) dc[j] = static_cast<int16_t>(a0);
}

}  // namespace jpeggpu

extern "C" int jpeggpu_expand_supertiles(const void* stiles, const void* base,
                                         const void* q, void* rows, void* dc,
                                         int n_st, int super_d, int W,
                                         int group_du, int n_rows,
                                         void* stream) {
  using namespace jpeggpu;
  if (n_rows <= 0) return 0;
  const long long threads = static_cast<long long>(n_rows) * 8;
  const unsigned grid =
      static_cast<unsigned>((threads + kExpandThreads - 1) / kExpandThreads);
  expand_supertiles_kernel<<<grid, kExpandThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(stiles), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(q), static_cast<int16_t*>(rows),
      static_cast<int16_t*>(dc), n_st, super_d, W, group_du, n_rows);
  return static_cast<int>(cudaGetLastError());
}
