// K3: stream-order coefficients of a scan -> the uint8 pixel planes of its
// components, all of them in one launch, for one image or for B images of
// one geometry (a merged group), each with its own quantisation tables.
//
// Replaces the Pallas kernel `_stream_idct_kernel` behind
// `jpeggpu_tpu/ops/idct_pallas.py: idct_stream_to_plane`, which the
// reference launches once per component; here one launch covers up to four
// components of the scan (a by-value descriptor per component: its slots in
// the MCU, its sampling factors, its table and its plane). For every data
// unit it does the de-interleave (it reads the unit where the
// MCU-interleaved stream has it), splices the un-deltaed DC from the side
// vector into slot 0, dequantises with the table bytes read as signed int8
// and the product wrapped to int16, runs the column and the row pass of
// the fixed-point AAN transform (every pass result wrapped to int16), adds
// 128, clamps and stores 8x8 pixels at the plane's pitch.
//
// What bounds it on an H100: bytes, with the integer pipes close behind.
// Each coefficient is read once (2 B) and each pixel written once (1 B),
// against ~20 integer operations per pixel, which the card's 64 integer
// lanes per SM and clock (for adds and shifts, as many again for
// multiplies) do in about as long as the bytes take. The design:
//
// - Work unit: a run of R consecutive MCUs of one MCU row (R a power of
//   two with R * du_per_mcu <= 128, chosen by the host; the last run of a
//   row takes the rest), across all listed components. Its coefficients
//   are one contiguous range of the stream, R * du_per_mcu * 128 bytes.
// - Batch: the grid's second dimension is the image. B images one after
//   another in the stream, the DC vector and each component's [B, H, W]
//   plane are one image B times as tall, so image b's MCU row y is row
//   b * mcus_y + y of that stacked image; only the tables are the image's
//   own, staged once per block. Each image's bytes in and out, and so the
//   bound per image, are those of one image alone.
// - Staging: persistent blocks (as many as fit on the card) walk the runs;
//   each stages a run in shared memory with one 1-D bulk copy
//   (bulk_copy.cuh) issued by one thread and completed on an mbarrier, in a
//   ring of two stages, so that the next run loads while this one is
//   transformed. No thread spends a register or an instruction on the
//   loads, and the copy reads every line whole, once.
// - Transform: one thread per data unit. Threads take the run's units in
//   plane order (consecutive threads: horizontally adjacent blocks of one
//   component), so that a warp's stores of one pixel row are contiguous
//   runs of 8-byte stores, whole sectors. The thread -> data unit mapping
//   (three integer divisions) is worked out once per block for a whole run
//   and again only for a row's shorter last run. A unit's 128 bytes sit at
//   a 128-byte stride in shared memory, so eight lanes reading the same
//   16-byte chunk would hit one bank group; each lane reads its chunks in
//   the order k ^ (lane & 7) instead (no conflict within a quarter warp)
//   and swaps them back into order with three rounds of selects.
// - The level shift rides on the row pass's rounding bias and the clamp and
//   pack are one instruction per two pixels (idct_common.cuh).
//
// Measured against two other designs on the card (the same kernel with
// direct 16-byte loads from device memory and no staging; each thread
// staging its own unit with a 128-byte bulk copy into a padded place, no
// reordering), this one was the fastest in a decode.
//
// The 8-point pass, the level shift, the clamp and the block transform live
// in idct_common.cuh, shared with K9 (idct_blocks.cu).

#include "bulk_copy.cuh"
#include "idct_common.cuh"

namespace jpeggpu {

constexpr int kMaxComps = 4;
constexpr int kRunStages = 2;
constexpr int kMaxRunUnits = 128;  // threads of a block at most

struct StreamComp {
  uint8_t* plane;
  int off, ssx, ssy, qidx;
  int first;  // per MCU of a run: data units of the components listed before
};

struct StreamRuns {
  const int16_t* coeffs;
  const int16_t* dc;
  const int32_t* qtables;
  StreamComp comp[kMaxComps];
  int n_comps;
  int units;  // data units per MCU over the listed components
  int mcus_x, du_per_mcu, run_mcus, runs_per_row, n_runs;  // per image
  int mcus_y;  // MCU rows per image
  int q_stride;  // table values per image: n tables x 64
};

struct Run {
  int my, mx0, n;  // MCU row of the stacked images, first MCU column, MCUs
};

// run `run` of image `img`
__device__ __forceinline__ Run run_at(const StreamRuns& a, int img,
                                      int run) {
  Run r;
  const int row = run / a.runs_per_row;
  r.my = img * a.mcus_y + row;
  r.mx0 = (run - row * a.runs_per_row) * a.run_mcus;
  r.n = min(a.run_mcus, a.mcus_x - r.mx0);
  return r;
}

// Thread `tid`'s data unit of a run of n MCUs, in plane order: its
// component c, its slot du in the run's stretch of the stream, and its
// block row sy (in the MCU row) and block column bx (in the run).
struct Unit {
  int c, du, sy, bx;
};

__device__ __forceinline__ Unit unit_of(const StreamRuns& a, int n, int tid) {
  Unit u;
  u.c = 0;
#pragma unroll
  for (int j = 1; j < kMaxComps; ++j) {
    if (j < a.n_comps && tid >= n * a.comp[j].first) u.c = j;
  }
  StreamComp cc = a.comp[0];
#pragma unroll
  for (int j = 1; j < kMaxComps; ++j) {
    if (j == u.c) cc = a.comp[j];
  }
  const int local = tid - n * cc.first;
  const int w = n * cc.ssx;  // the run's blocks in one block row
  u.sy = local / w;
  u.bx = local - u.sy * w;
  const int mx = u.bx / cc.ssx;
  const int sx = u.bx - mx * cc.ssx;
  u.du = mx * a.du_per_mcu + cc.off + u.sy * cc.ssx + sx;
  return u;
}

__device__ __forceinline__ void load_run(const StreamRuns& a, int img,
                                         int run, uint8_t* dst,
                                         uint64_t* bar) {
  const Run r = run_at(a, img, run);
  const uint32_t bytes = static_cast<uint32_t>(r.n * a.du_per_mcu) * 128u;
  mbar_expect_tx(bar, bytes);
  bulk_load(dst,
            a.coeffs + (static_cast<int64_t>(r.my) * a.mcus_x + r.mx0) *
                           a.du_per_mcu * 64,
            bytes, bar);
}

// rows[k] holds row k ^ s: swap them back into order
__device__ __forceinline__ void unscramble(int4 (&rows)[8], int s) {
#pragma unroll
  for (int b = 1; b < 8; b <<= 1) {
    const bool flip = s & b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j & b) continue;
      const int4 lo = rows[j], hi = rows[j | b];
      rows[j] = flip ? hi : lo;
      rows[j | b] = flip ? lo : hi;
    }
  }
}

// the transform of one data unit from its rows; stores its pixels
__device__ __forceinline__ void unit_pixels(const StreamRuns& a, const Run& r,
                                            const Unit& u, int4 (&rows)[8],
                                            const uint32_t* q) {
  StreamComp cc = a.comp[0];
#pragma unroll
  for (int j = 1; j < kMaxComps; ++j) {
    if (j == u.c) cc = a.comp[j];
  }
  uint32_t v[64];
  unpack_rows(rows, v);
  const int64_t gdu =
      (static_cast<int64_t>(r.my) * a.mcus_x + r.mx0) * a.du_per_mcu + u.du;
  v[0] = static_cast<uint32_t>(static_cast<int32_t>(a.dc[gdu]));
  const int64_t pitch = static_cast<int64_t>(a.mcus_x) * cc.ssx * 8;
  uint8_t* dst =
      cc.plane +
      (static_cast<int64_t>(r.my) * cc.ssy + u.sy) * 8 * pitch +
      static_cast<int64_t>(r.mx0 * cc.ssx + u.bx) * 8;
  dequant_idct_store(v, q, dst, pitch);
}

__global__ void __launch_bounds__(kMaxRunUnits)
idct_stream_to_planes_kernel(const StreamRuns a) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t full[kRunStages];
  __shared__ __align__(16) uint32_t q[kMaxComps][64];
  const int tid = threadIdx.x;
  const int img = blockIdx.y;
  const int32_t* qt = a.qtables + static_cast<int64_t>(img) * a.q_stride;
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) {
    if (c >= a.n_comps) break;
    for (int i = tid; i < 64; i += blockDim.x) {
      q[c][i] = qvalue(qt[a.comp[c].qidx * 64 + i]);
    }
  }
  const int stage_bytes = a.run_mcus * a.du_per_mcu * 128;
  if (tid == 0) {
    for (int s = 0; s < kRunStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kRunStages; ++s) {
      const int run = blockIdx.x + s * gridDim.x;
      if (run < a.n_runs) {
        load_run(a, img, run, stage + s * stage_bytes, &full[s]);
      }
    }
  }
  // a whole run's units are the same for every run: worked out once
  const Unit whole = unit_of(a, a.run_mcus, tid);
  const int lane8 = tid & 7;
  int i = 0;
  for (int run = blockIdx.x; run < a.n_runs; run += gridDim.x, ++i) {
    const int slot = i % kRunStages;
    const Run r = run_at(a, img, run);
    mbar_wait(&full[slot], (i / kRunStages) & 1);
    if (tid < r.n * a.units) {
      const Unit u = r.n == a.run_mcus ? whole : unit_of(a, r.n, tid);
      const uint8_t* src = stage + slot * stage_bytes + u.du * 128;
      int4 rows[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        rows[k] = *reinterpret_cast<const int4*>(src + ((k ^ lane8) << 4));
      }
      unscramble(rows, lane8);
      unit_pixels(a, r, u, rows, q[u.c]);
    }
    __syncthreads();  // every read of this slot is done
    if (tid == 0) {
      const int next = run + kRunStages * gridDim.x;
      if (next < a.n_runs) {
        fence_proxy_async();
        load_run(a, img, next, stage + slot * stage_bytes, &full[slot]);
      }
    }
  }
}

}  // namespace jpeggpu

// desc (host memory, int64): mcus_x, du_per_mcu, units, run_mcus,
// runs_per_row, n_runs, threads, batch, mcus_y, q_stride; then per
// component: plane pointer, off, ssx, ssy, table index, first. The division
// of an image into runs is the host's (ops/idct.py: stream_runs); the grid
// is batch images high and, across them, as many blocks as fit on the card
// at once, at most one per run of an image.
extern "C" int jpeggpu_idct_stream_to_planes(const void* coeffs,
                                             const void* dc,
                                             const void* qtables,
                                             const int64_t* desc,
                                             int n_comps, void* stream) {
  using namespace jpeggpu;
  if (n_comps < 1 || n_comps > kMaxComps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StreamRuns a{};
  a.coeffs = static_cast<const int16_t*>(coeffs);
  a.dc = static_cast<const int16_t*>(dc);
  a.qtables = static_cast<const int32_t*>(qtables);
  a.n_comps = n_comps;
  a.mcus_x = static_cast<int>(desc[0]);
  a.du_per_mcu = static_cast<int>(desc[1]);
  a.units = static_cast<int>(desc[2]);
  a.run_mcus = static_cast<int>(desc[3]);
  a.runs_per_row = static_cast<int>(desc[4]);
  a.n_runs = static_cast<int>(desc[5]);
  const int threads = static_cast<int>(desc[6]);
  const int batch = static_cast<int>(desc[7]);
  a.mcus_y = static_cast<int>(desc[8]);
  a.q_stride = static_cast<int>(desc[9]);
  for (int c = 0; c < n_comps; ++c) {
    const int64_t* d = desc + 10 + 6 * c;
    a.comp[c].plane = reinterpret_cast<uint8_t*>(d[0]);
    a.comp[c].off = static_cast<int>(d[1]);
    a.comp[c].ssx = static_cast<int>(d[2]);
    a.comp[c].ssy = static_cast<int>(d[3]);
    a.comp[c].qidx = static_cast<int>(d[4]);
    a.comp[c].first = static_cast<int>(d[5]);
  }
  if (a.n_runs == 0 || batch == 0) return 0;
  if (batch < 0 || batch > 65535 ||
      static_cast<int64_t>(a.runs_per_row) * a.mcus_y != a.n_runs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads < 32 || threads > kMaxRunUnits || threads % 32 ||
      a.run_mcus * a.units > threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(kRunStages) * a.run_mcus * a.du_per_mcu * 128;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, idct_stream_to_planes_kernel, threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = max(1, per_sm) * sms;
  const dim3 grid(min(a.n_runs, (resident + batch - 1) / batch), batch);
  idct_stream_to_planes_kernel<<<grid, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
