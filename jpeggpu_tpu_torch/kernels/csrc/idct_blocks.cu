// K9: int16 coefficient planes -> their uint8 pixel planes, 8x8 block by
// 8x8 block, up to four planes of different shapes in one launch:
// dequantise (table bytes read as signed int8, product wrapped to int16),
// column and row pass of the fixed-point AAN transform (every pass result
// wrapped to int16), add 128, clamp to 0..255.
//
// Replaces the Pallas kernel `_idct_kernel` behind
// `jpeggpu_tpu/ops/idct_pallas.py: dequant_idct_blocks_pallas`, together
// with the transposes of its caller `jpeggpu_tpu/ops/idct.py:
// dequant_idct_plane` (plane -> int32 (N, 8, 8) blocks -> plane), which
// fold into this kernel's addressing. The TPU kernel takes int32 blocks;
// reading the int16 plane loses nothing, since the dequantisation wraps
// mod 2^16 either way. On the card it runs in the sharded decode's row-chunk
// tail (`parallel/segments.py`), once per shard for all the planes of the
// shard's chunk, after the chunk's de-interleave.
//
// What bounds it on an H100: bytes, with the integer pipes close behind.
// Each coefficient is read once (2 B) and each pixel written once (1 B)
// against ~19 integer operations per pixel, as in K3 (idct_stream.cu, whose
// block transform it shares through idct_common.cuh). One chunk's plane is
// small (a chroma chunk of 384x2016 is 12 096 blocks, under one wave of
// the card), so the launch covers all planes of the chunk: the grid walks one
// flat list of blocks, plane after plane and in each plane 8-row strip
// after 8-row strip (the host numbers each plane's first block), and every
// SM has blocks of every plane in flight. One thread owns one 8x8 block,
// issues its eight 16-byte row loads at once, keeps the 64 values in
// registers through both passes and stores eight 8-byte pixel rows.
// Neighbouring threads own neighbouring blocks of one strip, so a warp's
// loads of one coefficient row are one contiguous 512-byte run and its
// stores of one pixel row one contiguous 256-byte run.

#include "idct_common.cuh"

namespace jpeggpu {

constexpr int kMaxPlanes = 4;
constexpr int kIdctBlocksPerCta = 128;

struct BlockPlane {
  const int16_t* in;
  uint8_t* out;
  const int32_t* q;
  int width;  // pixels, a multiple of 8
  int first;  // the plane's first block in the flat list
};

struct BlockPlanes {
  BlockPlane plane[kMaxPlanes];
  int n, total;
};

__global__ void __launch_bounds__(kIdctBlocksPerCta)
dequant_idct_planes_kernel(const BlockPlanes a) {
  __shared__ __align__(16) uint32_t q[kMaxPlanes][64];
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    if (p >= a.n) break;
    for (int i = threadIdx.x; i < 64; i += blockDim.x) {
      q[p][i] = qvalue(a.plane[p].q[i]);
    }
  }
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.total) return;
  int p = 0;
#pragma unroll
  for (int j = 1; j < kMaxPlanes; ++j) {
    if (j < a.n && idx >= a.plane[j].first) p = j;
  }
  BlockPlane bp = a.plane[0];
#pragma unroll
  for (int j = 1; j < kMaxPlanes; ++j) {
    if (j == p) bp = a.plane[j];
  }
  const int blocks_x = bp.width >> 3;
  const int local = idx - bp.first;
  const int by = local / blocks_x;
  const int bx = local - by * blocks_x;
  const int64_t origin = static_cast<int64_t>(by) * 8 * bp.width + bx * 8;

  int4 rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rows[i] = __ldg(
        reinterpret_cast<const int4*>(bp.in + origin + i * bp.width));
  }
  uint32_t v[64];
  unpack_rows(rows, v);
  dequant_idct_store(v, q[p], bp.out + origin, bp.width);
}

}  // namespace jpeggpu

// desc (host memory, int64): total blocks, then per plane: input pointer,
// output pointer, table pointer, width, first block (ops/idct.py:
// plane_blocks numbers them).
extern "C" int jpeggpu_dequant_idct_planes(const int64_t* desc, int n,
                                           void* stream) {
  using namespace jpeggpu;
  if (n < 1 || n > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  BlockPlanes a{};
  a.n = n;
  a.total = static_cast<int>(desc[0]);
  for (int p = 0; p < n; ++p) {
    const int64_t* d = desc + 1 + 5 * p;
    a.plane[p].in = reinterpret_cast<const int16_t*>(d[0]);
    a.plane[p].out = reinterpret_cast<uint8_t*>(d[1]);
    a.plane[p].q = reinterpret_cast<const int32_t*>(d[2]);
    a.plane[p].width = static_cast<int>(d[3]);
    a.plane[p].first = static_cast<int>(d[4]);
  }
  if (a.total == 0) return 0;
  const dim3 grid((a.total + kIdctBlocksPerCta - 1) / kIdctBlocksPerCta);
  dequant_idct_planes_kernel<<<grid, kIdctBlocksPerCta, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
