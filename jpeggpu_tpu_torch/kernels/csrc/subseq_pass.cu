// K1: one speculative / synchronising decode pass over every subsequence.
//
// Replaces the Pallas kernel `_sync_kernel` behind
// `jpeggpu_tpu/ops/huffman_pallas.py: subseq_pass`. Contract (the same):
// lane i starts at state (p0, c0, z0)[i], decodes symbols of its own
// 1024-bit subsequence until the next symbol would cross `end_subseq[i]`,
// and returns the state after the last committed symbol plus `n`, the
// coefficient positions (run + 1 per symbol) it produced. It writes no
// coefficients. Lanes with active0 == 0 or p0 >= end_subseq return their
// start state and n = 0.
//
// What bounds it on an H100: not bytes (a pass reads each 128-byte
// subsequence once, 2.6 MB at 12 MP) but the chain of dependent
// instructions per symbol: peek, 4 shared-memory compares of the limit
// search, the vsm and huffval lookups, the state update and the buffer
// shift, each waiting for the one before, times the ~250 symbols of the
// longest lane of a warp. The design keeps that chain short and off device
// memory: one thread per subsequence (no 34-row window; a thread reads its
// words straight from global memory, one 4-byte load per 32 bits consumed),
// a 64-bit bit buffer in registers, all tables of the scan in 3.7 KB of
// shared memory, and one-warp blocks so that the 640 warps of a 12 MP
// image spread over all SMs and a slow lane holds back only 31 others.

#include "huffman_common.cuh"

namespace jpeggpu {

template <bool FAST>
__global__ void __launch_bounds__(kEntropyBlock)
subseq_pass_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ word_end,
                   const int32_t* __restrict__ seg_base_bits,
                   const int32_t* __restrict__ end_subseq,
                   const int32_t* __restrict__ maxcode,
                   const int32_t* __restrict__ vsm,
                   const int32_t* __restrict__ limits,
                   const int32_t* __restrict__ huffval,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ p0,
                   const int32_t* __restrict__ c0,
                   const int32_t* __restrict__ z0,
                   const uint8_t* __restrict__ active0,
                   int32_t* __restrict__ p_out, int32_t* __restrict__ c_out,
                   int32_t* __restrict__ z_out, int32_t* __restrict__ n_out,
                   int lanes, int du_per_mcu) {
  __shared__ HuffTables tables;
  load_tables(tables, maxcode, vsm, limits, huffval, slots, du_per_mcu);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  int p = p0[lane];
  int c = c0[lane];
  int z = z0[lane];
  int n = 0;
  const int end = end_subseq[lane];
  if (active0[lane] != 0 && p < end) {
    const int base = seg_base_bits[lane];
    BitReader br;
    br.words = words;
    br.word_end = word_end[lane];
    br.seek(base + p);
    while (true) {
      const Symbol s = decode_symbol<FAST, false>(tables, br.peek(), c, z);
      if (p + s.length > end) break;  // belongs to the next subsequence
      p += s.length;
      n += s.run + 1;
      advance_cz(c, z, s.run, du_per_mcu);
      if (s.length < 32) {
        br.skip(s.length);
      } else {  // only a garbage DC category is this long
        br.seek(base + p);
      }
    }
  }
  p_out[lane] = p;
  c_out[lane] = c;
  z_out[lane] = z;
  n_out[lane] = n;
}

}  // namespace jpeggpu

extern "C" int jpeggpu_subseq_pass(
    const void* words, const void* word_end, const void* seg_base_bits,
    const void* end_subseq, const void* maxcode, const void* vsm,
    const void* limits, const void* huffval, const void* slots,
    const void* p0, const void* c0, const void* z0, const void* active0,
    void* p_out, void* c_out, void* z_out, void* n_out, int lanes,
    int du_per_mcu, int fast_tables, void* stream) {
  using namespace jpeggpu;
  const dim3 block(kEntropyBlock);
  const dim3 grid((lanes + kEntropyBlock - 1) / kEntropyBlock);
  auto* kernel = fast_tables ? subseq_pass_kernel<true>
                             : subseq_pass_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(word_end),
      static_cast<const int32_t*>(seg_base_bits),
      static_cast<const int32_t*>(end_subseq),
      static_cast<const int32_t*>(maxcode), static_cast<const int32_t*>(vsm),
      static_cast<const int32_t*>(limits),
      static_cast<const int32_t*>(huffval),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(p0),
      static_cast<const int32_t*>(c0), static_cast<const int32_t*>(z0),
      static_cast<const uint8_t*>(active0), static_cast<int32_t*>(p_out),
      static_cast<int32_t*>(c_out), static_cast<int32_t*>(z_out),
      static_cast<int32_t*>(n_out), lanes, du_per_mcu);
  return static_cast<int>(cudaGetLastError());
}
