// K4: the writing decode in record-emission form, first stage of the
// records write path.
//
// Replaces `jpeggpu_tpu/ops/huffman_pallas.py: emit_pass` (kernel body
// `_emit_kernel`). Contract: lane i re-decodes its subsequence from
// (p0, c0, z0)[i] and stores one packed int32 record per committed symbol
// at rec[slot * lanes + i], slot counting the lane's symbols from 0:
//   (value << 16) | ((wp - pos0[i]) & 0xFFFF)
// with wp the symbol's output position (zig-zag order within its data
// unit). The value is 0 for a symbol that writes nothing (EOB, ZRL, a zero
// DC difference) and for a position at or past bound[i]; the position is
// recorded all the same. m[i] is the number of records of lane i. The lane
// stops when its next symbol would cross end_subseq[i], when its position
// reaches bound[i], or at s_cap records. Slots at and past m[i] are not
// written.
//
// The TPU kernel leaves inert holes between committed slots where its
// rolling 8-word buffer stalls; a thread with a register bit reader never
// stalls, so the records here are dense (slot s is the lane's s-th symbol).
// Consumers hold to "slot real iff s < m[i] and local position >= 0", which
// covers both.
//
// What bounds it on an H100: like K2, the chain of dependent operations
// of the slowest lane's symbols, not bytes (a 12 MP image emits ~3.5 M
// records = 14 MB). The chain and its design are K2's (decode_write.cu;
// huffman_common.cuh next_symbol, UnitSlots, BitReader::skip_predicated):
// one shared-memory load of the per-scan symbol table resolves a symbol
// whose code has at most 10 bits, the value is EXTENDed from the stream
// bits, the data unit's table slots stay in registers (the MCU's slot pairs
// arrive packed in a 64-bit kernel argument), the refill's load is
// predicated, and an escaped symbol takes decode_symbol_in's search over
// the named slots' packed tables in shared memory. Each block copies the
// named slots into shared memory (9.5 KB at 12 MP) in one batch of 16-byte
// loads, while the lane's start loads (read before the copy's barrier, as
// in K1: read after it, they and the first words' loads came one after the
// other behind the barrier, and K4 took about a third longer on an H100).
// What the record form adds to K2's chain is the store, which does not feed
// the chain: the lanes of a warp store slot s to 32 neighbouring int32, one
// 128-byte line, where K2's stores of a warp land in 32 different data
// units.

#include "huffman_common.cuh"

namespace jpeggpu {

template <bool FAST>
__global__ void __launch_bounds__(kEntropyBlock)
emit_pass_kernel(const uint32_t* __restrict__ words,
                 const int32_t* __restrict__ word_end,
                 const int32_t* __restrict__ seg_base_bits,
                 const int32_t* __restrict__ end_subseq,
                 const int16_t* __restrict__ symtab,
                 const int32_t* __restrict__ maxcode,
                 const int32_t* __restrict__ vsm,
                 const int32_t* __restrict__ limits,
                 const int32_t* __restrict__ huffval,
                 const int32_t* __restrict__ p0,
                 const int32_t* __restrict__ c0,
                 const int32_t* __restrict__ z0,
                 const int32_t* __restrict__ pos0,
                 const int32_t* __restrict__ bound,
                 const uint8_t* __restrict__ active0,
                 int32_t* __restrict__ rec, int32_t* __restrict__ m,
                 uint64_t pairs, int lanes, int s_cap, int du_per_mcu) {
  __shared__ SymbolTable tab;
  // the lane's start, read before the table copy's barrier so that the
  // loads overlap it, as in K1
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < lanes && active0[lane] != 0;
  int p = 0, start = 0, end = 0, bnd = 0, base = 0, w_end = 0, c = 0, z = 0;
  if (live) {
    p = p0[lane];
    c = c0[lane];
    z = z0[lane];
    start = pos0[lane];
    end = end_subseq[lane];
    bnd = bound[lane];
    base = seg_base_bits[lane];
    w_end = word_end[lane];
  }
  load_symbol_table<FAST>(tab, symtab, maxcode, vsm, limits, huffval, pairs,
                          du_per_mcu);
  if (lane >= lanes) return;
  if (!live) {
    m[lane] = 0;
    return;
  }

  int pos = start;
  BitReader br;
  br.words = words;
  br.word_end = w_end;
  br.seek(base + p);
  UnitSlots u(pairs, du_per_mcu, c, z);
  int slot = 0;
  int32_t* out = rec + lane;
  while (pos < bnd && slot < s_cap) {
    const Symbol s = next_symbol<FAST, true>(tab, br, u.off, u.z, base, p);
    if (p + s.length > end) break;  // belongs to the next subsequence
    p += s.length;
    const int wp = pos + s.run;
    const uint32_t value = wp < bnd ? static_cast<uint32_t>(s.value) : 0u;
    *out = static_cast<int32_t>(
        (value << 16) | (static_cast<uint32_t>(wp - start) & 0xFFFFu));
    out += lanes;
    slot += 1;
    pos = wp + 1;
    u.advance(s.run);
  }
  m[lane] = slot;
}

}  // namespace jpeggpu

extern "C" int jpeggpu_emit_pass(
    const void* words, const void* word_end, const void* seg_base_bits,
    const void* end_subseq, const void* symtab, const void* maxcode,
    const void* vsm, const void* limits, const void* huffval,
    const void* p0, const void* c0, const void* z0, const void* pos0,
    const void* bound, const void* active0, void* rec, void* m,
    unsigned long long pairs, int lanes, int s_cap, int du_per_mcu,
    int fast_tables, void* stream) {
  using namespace jpeggpu;
  const dim3 block(kEntropyBlock);
  const dim3 grid((lanes + kEntropyBlock - 1) / kEntropyBlock);
  auto* kernel = fast_tables ? emit_pass_kernel<true>
                             : emit_pass_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(word_end),
      static_cast<const int32_t*>(seg_base_bits),
      static_cast<const int32_t*>(end_subseq),
      static_cast<const int16_t*>(symtab),
      static_cast<const int32_t*>(maxcode), static_cast<const int32_t*>(vsm),
      static_cast<const int32_t*>(limits),
      static_cast<const int32_t*>(huffval), static_cast<const int32_t*>(p0),
      static_cast<const int32_t*>(c0), static_cast<const int32_t*>(z0),
      static_cast<const int32_t*>(pos0), static_cast<const int32_t*>(bound),
      static_cast<const uint8_t*>(active0), static_cast<int32_t*>(rec),
      static_cast<int32_t*>(m), static_cast<uint64_t>(pairs), lanes, s_cap,
      du_per_mcu);
  return static_cast<int>(cudaGetLastError());
}
