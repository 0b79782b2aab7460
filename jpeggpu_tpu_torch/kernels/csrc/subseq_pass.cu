// K1: one whole round of the state synchronisation over every subsequence.
//
// Replaces the Pallas kernel `_sync_kernel` behind
// `jpeggpu_tpu/ops/huffman_pallas.py: subseq_pass`, and with it the tensor
// code that sync_states ran around it in every round (the shift of the
// states by one lane, the freeze of padded lanes, the convergence test).
// Contract (ops/huffman.py subseq_pass, whose plain version is the round in
// tensor code): lane i takes its start state itself, blind at
// (rel * 1024, 0, 0) on the blind round (no previous states) or where it is
// the first of its segment, `entry` for lane 0 of a subsequence shard, else
// lane i-1's end state of the previous round (lane 0 takes the last lane's,
// as torch.roll does). A valid lane decodes symbols of its own 1024-bit
// subsequence until the next symbol would cross its end, and writes the
// state after the last committed symbol and `n`, the coefficient positions
// (run + 1 per symbol) it produced; it writes no coefficients. A lane that
// is not valid is frozen at (rel * 1024, 0, 0, 0). With a flag, a lane whose
// state changed against the previous round and whose successor takes its
// start from it raises the round's flag: one warp vote and one store per
// warp, so the host reads one word per round and launches nothing else.
//
// What bounds it on an H100: not bytes (a round reads each 128-byte
// subsequence once, 2.6 MB at 12 MP) but the chain of dependent
// instructions per symbol on the longest lane of a warp (~200 symbols at
// 12 MP, quality 90, 340 iterations of its slowest warp on a shifted
// round). The chain is one shared-memory load of the symbol table
// (huffman_common.cuh next_symbol) and about ten integer operations for
// every symbol whose code has at most 10 bits, then the state update and
// the buffer shift. What the design does about it: the data unit's table
// slots stay in registers (UnitSlots: the MCU's slot pairs arrive packed in
// a 64-bit kernel argument, the next data unit's are kept ready), so
// advancing c reads no memory and takes no branch; the buffer moves inside
// the escape branch, so a common symbol passes no 32-bit-length test; the
// refill's load is predicated, not branched around. In a warp the escape
// (1.2% of symbols at quality 90, but some lane in about a third of the
// iterations) and the refill are the divergent paths left. Escaped symbols
// take decode_symbol_in's search over the named slots' packed tables in
// shared memory. One thread per subsequence, a 64-bit bit buffer in
// registers, one-warp blocks so that the 640 warps of a 12 MP image spread
// over all SMs and a slow lane holds back only 31 others. Each block copies
// the named slots into shared memory, 2 KB of symbol table and 0.4 KB of
// escape tables a slot (9.5 KB for the 12 MP image's four), while its
// lanes' start states load.

#include "huffman_common.cuh"

namespace jpeggpu {

template <bool FAST>
__global__ void __launch_bounds__(kEntropyBlock)
subseq_pass_kernel(const uint32_t* __restrict__ words,
                   const int32_t* __restrict__ word_end,
                   const int32_t* __restrict__ seg_base_bits,
                   const int32_t* __restrict__ end_subseq,
                   const int32_t* __restrict__ rel,
                   const uint8_t* __restrict__ valid,
                   const int16_t* __restrict__ symtab,
                   const int32_t* __restrict__ maxcode,
                   const int32_t* __restrict__ vsm,
                   const int32_t* __restrict__ limits,
                   const int32_t* __restrict__ huffval,
                   const int32_t* __restrict__ p_prev,
                   const int32_t* __restrict__ c_prev,
                   const int32_t* __restrict__ z_prev,
                   const int32_t* __restrict__ entry,
                   int32_t* __restrict__ p_out, int32_t* __restrict__ c_out,
                   int32_t* __restrict__ z_out, int32_t* __restrict__ n_out,
                   int32_t* __restrict__ flag, uint64_t pairs, int lanes,
                   int du_per_mcu) {
  __shared__ SymbolTable tab;
  // the lane's start, read before the table copy's barrier so that the
  // loads overlap it
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = lane < lanes;
  const int r = in ? rel[lane] : 0;
  const bool live = in && valid[lane] != 0;
  int p = r * kSubseqBits;  // the blind start, and the frozen state
  int c = 0;
  int z = 0;
  if (live && p_prev != nullptr && r != 0) {
    if (lane == 0 && entry != nullptr) {
      p = entry[0];
      c = entry[1];
      z = entry[2];
    } else {
      const int j = lane == 0 ? lanes - 1 : lane - 1;
      p = p_prev[j];
      c = c_prev[j];
      z = z_prev[j];
    }
  }
  load_symbol_table<FAST>(tab, symtab, maxcode, vsm, limits, huffval, pairs,
                          du_per_mcu);

  int n = 0;
  bool raise = false;
  if (live) {
    const int end = end_subseq[lane];
    if (p < end) {
      const int base = seg_base_bits[lane];
      BitReader br;
      br.words = words;
      br.word_end = word_end[lane];
      br.seek(base + p);
      UnitSlots u(pairs, du_per_mcu, c, z);
      while (true) {
        const Symbol s = next_symbol<FAST, false>(tab, br, u.off, u.z, base, p);
        if (p + s.length > end) break;  // belongs to the next subsequence
        p += s.length;
        n += s.run + 1;
        u.advance(s.run);
      }
      c = u.c;
      z = u.z;
    }
  }
  if (in) {
    if (flag != nullptr) {
      // roll(delta, 1) & frontier_ok, seen from the predecessor's side
      const bool delta =
          p != p_prev[lane] || c != c_prev[lane] || z != z_prev[lane];
      const int k = lane + 1 == lanes ? 0 : lane + 1;
      raise = delta && rel[k] != 0 && valid[k] != 0 &&
              !(k == 0 && entry != nullptr);
    }
    p_out[lane] = p;
    c_out[lane] = c;
    z_out[lane] = z;
    n_out[lane] = n;
  }
  if (__any_sync(0xffffffffu, raise) && (threadIdx.x & 31) == 0) *flag = 1;
}

// K1's gathered mode: the pass of a compacted sync round
// (ops/huffman.py subseq_pass_at; the Pallas kernel behind
// `jpeggpu_tpu/ops/huffman_pallas.py: subseq_pass` run on the context that
// `make_ctx_gatherer` compacts to the frontier's lanes). Column i decodes
// the subsequence of lane idx[i] from the explicit start (sp, sc, sz)[i]
// where active[i], with the symbol loop above; an inactive column keeps its
// start with n = 0. The caller resolves the start (a chain head's
// predecessor state, `entry`, or the previous phase's fresh state), so
// there is no flag and no entry here. The gather is the kernel's own
// indexed load of the lane's word_end, seg_base_bits and end_subseq; its
// words come through the same BitReader. What bounds it: the slowest
// column's symbols, as for the whole round, at a width of 32 to 5120
// columns instead of the scan's lanes.
template <bool FAST>
__global__ void __launch_bounds__(kEntropyBlock)
subseq_pass_at_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ word_end,
                      const int32_t* __restrict__ seg_base_bits,
                      const int32_t* __restrict__ end_subseq,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ sp,
                      const int32_t* __restrict__ sc,
                      const int32_t* __restrict__ sz,
                      const uint8_t* __restrict__ active,
                      const int16_t* __restrict__ symtab,
                      const int32_t* __restrict__ maxcode,
                      const int32_t* __restrict__ vsm,
                      const int32_t* __restrict__ limits,
                      const int32_t* __restrict__ huffval,
                      int32_t* __restrict__ p_out, int32_t* __restrict__ c_out,
                      int32_t* __restrict__ z_out, int32_t* __restrict__ n_out,
                      uint64_t pairs, int width, int du_per_mcu) {
  __shared__ SymbolTable tab;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < width;
  int p = 0;
  int c = 0;
  int z = 0;
  int lane = 0;
  bool live = false;
  if (in) {
    p = sp[i];
    c = sc[i];
    z = sz[i];
    lane = idx[i];
    live = active[i] != 0;
  }
  load_symbol_table<FAST>(tab, symtab, maxcode, vsm, limits, huffval, pairs,
                          du_per_mcu);

  int n = 0;
  if (live) {
    const int end = end_subseq[lane];
    if (p < end) {
      const int base = seg_base_bits[lane];
      BitReader br;
      br.words = words;
      br.word_end = word_end[lane];
      br.seek(base + p);
      UnitSlots u(pairs, du_per_mcu, c, z);
      while (true) {
        const Symbol s = next_symbol<FAST, false>(tab, br, u.off, u.z, base, p);
        if (p + s.length > end) break;  // belongs to the next subsequence
        p += s.length;
        n += s.run + 1;
        u.advance(s.run);
      }
      c = u.c;
      z = u.z;
    }
  }
  if (in) {
    p_out[i] = p;
    c_out[i] = c;
    z_out[i] = z;
    n_out[i] = n;
  }
}

}  // namespace jpeggpu

extern "C" int jpeggpu_subseq_pass_at(
    const void* words, const void* word_end, const void* seg_base_bits,
    const void* end_subseq, const void* idx, const void* sp, const void* sc,
    const void* sz, const void* active, const void* symtab,
    const void* maxcode, const void* vsm, const void* limits,
    const void* huffval, void* p_out, void* c_out, void* z_out, void* n_out,
    unsigned long long pairs, int width, int du_per_mcu, int fast_tables,
    void* stream) {
  using namespace jpeggpu;
  const dim3 block(kEntropyBlock);
  const dim3 grid((width + kEntropyBlock - 1) / kEntropyBlock);
  auto* kernel = fast_tables ? subseq_pass_at_kernel<true>
                             : subseq_pass_at_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(word_end),
      static_cast<const int32_t*>(seg_base_bits),
      static_cast<const int32_t*>(end_subseq),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(sp),
      static_cast<const int32_t*>(sc), static_cast<const int32_t*>(sz),
      static_cast<const uint8_t*>(active),
      static_cast<const int16_t*>(symtab),
      static_cast<const int32_t*>(maxcode), static_cast<const int32_t*>(vsm),
      static_cast<const int32_t*>(limits),
      static_cast<const int32_t*>(huffval), static_cast<int32_t*>(p_out),
      static_cast<int32_t*>(c_out), static_cast<int32_t*>(z_out),
      static_cast<int32_t*>(n_out), static_cast<uint64_t>(pairs), width,
      du_per_mcu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int jpeggpu_subseq_pass(
    const void* words, const void* word_end, const void* seg_base_bits,
    const void* end_subseq, const void* rel, const void* valid,
    const void* symtab, const void* maxcode, const void* vsm,
    const void* limits, const void* huffval, const void* p_prev,
    const void* c_prev, const void* z_prev, const void* entry, void* p_out,
    void* c_out, void* z_out, void* n_out, void* flag,
    unsigned long long pairs, int lanes, int du_per_mcu, int fast_tables,
    void* stream) {
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
      static_cast<const int32_t*>(rel), static_cast<const uint8_t*>(valid),
      static_cast<const int16_t*>(symtab),
      static_cast<const int32_t*>(maxcode), static_cast<const int32_t*>(vsm),
      static_cast<const int32_t*>(limits),
      static_cast<const int32_t*>(huffval),
      static_cast<const int32_t*>(p_prev), static_cast<const int32_t*>(c_prev),
      static_cast<const int32_t*>(z_prev), static_cast<const int32_t*>(entry),
      static_cast<int32_t*>(p_out), static_cast<int32_t*>(c_out),
      static_cast<int32_t*>(z_out), static_cast<int32_t*>(n_out),
      static_cast<int32_t*>(flag), static_cast<uint64_t>(pairs), lanes,
      du_per_mcu);
  return static_cast<int>(cudaGetLastError());
}
