// K2: the writing decode from synchronised start states.
//
// Replaces `jpeggpu_tpu/ops/huffman_pallas.py: decode_write_fused` as a
// whole: its Pallas kernel `_write_kernel`, the windowed scatter-add that
// places the kernel's per-lane (32, 64) data-unit windows, and the
// `scatter_finish` rounds for lanes that overflow the window. Contract:
// lane i re-decodes its subsequence from (p0, c0, z0)[i], owns the output
// positions from pos0[i] on, and stores every nonzero coefficient at
// `du * 64 + natural[zz]` of the zeroed int16 stream (natural order within
// a data unit, DC still difference-coded). It stops when its next symbol
// would cross `end_subseq[i]` or its position reaches `bound[i]`, the end
// of its restart segment's range; a store at or past `bound[i]` is dropped.
//
// What bounds it on an H100: bytes, nominally (the 36.6 MB stream of a
// 12 MP image is written once, zeros included), but like K1 a launch lasts
// as long as its slowest warp's chain of dependent instructions, so the
// measured time sits well above the byte bound. The chain and its design
// are K1's (subseq_pass.cu, huffman_common.cuh next_symbol and UnitSlots):
// one shared-memory load of the symbol table per symbol whose code has at
// most 10 bits, the category from the entry and the value EXTENDed from the
// stream bits as decode_symbol_in does it (the entry stores no value: one of
// up to 15 bits would not fit beside the fields in 16 bits), the data
// unit's table slots in registers; escaped symbols take decode_symbol_in's
// search over the named slots' packed tables in shared memory. Each block
// copies the named slots into shared memory (9.5 KB at 12 MP), as K1 does.
// The store does not feed the chain, but the 2-byte writes of a warp land
// on up to 32 cache lines each (ROADMAP §2.B). The design needs none of
// the TPU kernel's machinery because a thread can store 2 bytes anywhere:
// the position ranges [pos0, pos0 + n) of the lanes are disjoint by
// construction (pos0 is the exclusive scan of n), so there are no atomics,
// no per-lane window, no overflow path and no second pass. The wrapper
// zero-fills the stream; the kernel touches only nonzero coefficients.

#include "huffman_common.cuh"

namespace jpeggpu {

template <bool FAST>
__global__ void __launch_bounds__(kEntropyBlock)
decode_write_kernel(const uint32_t* __restrict__ words,
                    const int32_t* __restrict__ word_end,
                    const int32_t* __restrict__ seg_base_bits,
                    const int32_t* __restrict__ end_subseq,
                    const int16_t* __restrict__ symtab,
                    const int32_t* __restrict__ maxcode,
                    const int32_t* __restrict__ vsm,
                    const int32_t* __restrict__ limits,
                    const int32_t* __restrict__ huffval,
                    const int32_t* __restrict__ natural,
                    const int32_t* __restrict__ p0,
                    const int32_t* __restrict__ c0,
                    const int32_t* __restrict__ z0,
                    const int32_t* __restrict__ pos0,
                    const int32_t* __restrict__ bound,
                    const uint8_t* __restrict__ active0,
                    int16_t* __restrict__ out, uint64_t pairs, int lanes,
                    int du_per_mcu) {
  __shared__ SymbolTable tab;
  __shared__ uint8_t nat[64];  // zig-zag index -> raster index
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    nat[i] = static_cast<uint8_t>(natural[i]);
  }
  load_symbol_table<FAST>(tab, symtab, maxcode, vsm, limits, huffval, pairs,
                          du_per_mcu);

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes || active0[lane] == 0) return;

  int p = p0[lane];
  int pos = pos0[lane];
  const int end = end_subseq[lane];
  const int bnd = bound[lane];
  const int base = seg_base_bits[lane];
  BitReader br;
  br.words = words;
  br.word_end = word_end[lane];
  br.seek(base + p);
  UnitSlots u(pairs, du_per_mcu, c0[lane], z0[lane]);
  while (pos < bnd) {
    const Symbol s = next_symbol<FAST, true>(tab, br, u.off, u.z, base, p);
    if (p + s.length > end) break;  // belongs to the next subsequence
    p += s.length;
    const int wp = pos + s.run;
    if (s.value != 0 && wp < bnd) {
      out[(wp & ~63) + nat[wp & 63]] = static_cast<int16_t>(s.value);
    }
    pos = wp + 1;
    u.advance(s.run);
  }
}

}  // namespace jpeggpu

extern "C" int jpeggpu_decode_write(
    const void* words, const void* word_end, const void* seg_base_bits,
    const void* end_subseq, const void* symtab, const void* maxcode,
    const void* vsm, const void* limits, const void* huffval,
    const void* natural, const void* p0, const void* c0, const void* z0,
    const void* pos0, const void* bound, const void* active0, void* out,
    unsigned long long pairs, int lanes, int du_per_mcu, int fast_tables,
    void* stream) {
  using namespace jpeggpu;
  const dim3 block(kEntropyBlock);
  const dim3 grid((lanes + kEntropyBlock - 1) / kEntropyBlock);
  auto* kernel = fast_tables ? decode_write_kernel<true>
                             : decode_write_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(word_end),
      static_cast<const int32_t*>(seg_base_bits),
      static_cast<const int32_t*>(end_subseq),
      static_cast<const int16_t*>(symtab),
      static_cast<const int32_t*>(maxcode), static_cast<const int32_t*>(vsm),
      static_cast<const int32_t*>(limits),
      static_cast<const int32_t*>(huffval),
      static_cast<const int32_t*>(natural), static_cast<const int32_t*>(p0),
      static_cast<const int32_t*>(c0), static_cast<const int32_t*>(z0),
      static_cast<const int32_t*>(pos0), static_cast<const int32_t*>(bound),
      static_cast<const uint8_t*>(active0), static_cast<int16_t*>(out),
      static_cast<uint64_t>(pairs), lanes, du_per_mcu);
  return static_cast<int>(cudaGetLastError());
}
