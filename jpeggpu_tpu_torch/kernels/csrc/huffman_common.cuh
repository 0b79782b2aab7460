// Shared device code of the two entropy-decode kernels (subseq_pass.cu,
// decode_write.cu): the Huffman tables in shared memory, a register bit
// reader over the destuffed big-endian word stream, and the one-symbol
// decode. Semantics follow the plain PyTorch version in ops/huffman.py
// (_load32, _decode_symbol, _symbol_step) statement for statement,
// including what it does on garbage: every shift count is masked or
// clamped as there, and arithmetic that may wrap is done unsigned.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jpeggpu {

constexpr int kTables = 8;        // 4 DC + 4 AC, slot = id * 2 + class
constexpr int kMaxDuPerMcu = 10;  // T.81 B.2.3
constexpr int kEntropyBlock = 32; // one warp: each thread walks its own stream

struct HuffTables {
  int32_t maxcode[kTables * 16];   // largest code of length l+1, or -1
  int32_t vsm[kTables * 16];       // valptr - mincode per length
  uint32_t limits[kTables * 16];   // first left-aligned value with a longer code
  uint8_t huffval[kTables * 256];  // symbol values in canonical order
  int32_t slot[2 * kMaxDuPerMcu];  // (dc table, ac table) per data unit of the MCU
};

// Cooperative copy of the per-scan tables into shared memory. Every thread
// of the block must call it (it ends in a barrier).
__device__ inline void load_tables(HuffTables& t, const int32_t* maxcode,
                                   const int32_t* vsm, const int32_t* limits,
                                   const int32_t* huffval, const int32_t* slots,
                                   int du_per_mcu) {
  for (int i = threadIdx.x; i < kTables * 16; i += blockDim.x) {
    t.maxcode[i] = maxcode[i];
    t.vsm[i] = vsm[i];
    t.limits[i] = static_cast<uint32_t>(limits[i]);
  }
  for (int i = threadIdx.x; i < kTables * 256; i += blockDim.x) {
    t.huffval[i] = static_cast<uint8_t>(huffval[i]);
  }
  for (int i = threadIdx.x; i < 2 * du_per_mcu; i += blockDim.x) {
    t.slot[i] = slots[i];
  }
  __syncthreads();
}

// MSB-first reader with a 64-bit buffer in registers. Words at or past the
// segment's end read as zero; nothing else bounds a read, so a thread may
// read into its neighbour's subsequence (the symbol that straddles the
// boundary is decoded and then not committed). The word after the buffer is
// kept preloaded in `ahead`: a refill consumes a value requested one refill
// earlier, so its global-load latency is off the per-symbol chain (without
// this, some lane of a warp refills in nearly every iteration and the whole
// warp waits for device memory each time).
struct BitReader {
  const uint32_t* words;
  int word_end;
  int next_word;   // index of the word held in `ahead`
  uint32_t ahead;
  uint64_t buf;  // the next `nbits` stream bits, left-aligned
  int nbits;     // >= 32 whenever peek() is called

  __device__ uint32_t load(int w) const {
    return w < word_end ? __ldg(words + w) : 0u;
  }

  __device__ void seek(int abs_bit) {
    const int w = abs_bit >> 5;
    const int b = abs_bit & 31;
    buf = (static_cast<uint64_t>(load(w)) << 32) | load(w + 1);
    buf <<= b;
    nbits = 64 - b;
    next_word = w + 2;
    ahead = load(next_word);
  }

  __device__ uint32_t peek() const { return static_cast<uint32_t>(buf >> 32); }

  // Advance by 0 < len < 32 bits.
  __device__ void skip(int len) {
    buf <<= len;
    nbits -= len;
    if (nbits < 32) {
      buf |= static_cast<uint64_t>(ahead) << (32 - nbits);
      nbits += 32;
      ahead = load(++next_word);
    }
  }
};

struct Symbol {
  int length;  // bits of the category code plus the value bits
  int run;     // zero coefficients skipped before this one
  int value;   // EXTENDed coefficient (0 where the symbol carries none)
};

// One symbol from the 32 left-aligned bits `data`, for data unit `c` of the
// MCU at zig-zag index `z`. FAST is the canonical-limit search, exact for
// tables whose code space does not saturate; otherwise the maxcode walk.
template <bool FAST, bool NEED_VALUE>
__device__ inline Symbol decode_symbol(const HuffTables& t, uint32_t data,
                                       int c, int z) {
  const bool is_dc = z == 0;
  const int tbl = t.slot[2 * c + (is_dc ? 0 : 1)];
  int l;  // code length - 1
  if (FAST) {
    // limits[tbl] is nondecreasing, so the number of entries <= data among
    // the first 15 is a lower-bound search: 4 compares
    const uint32_t* lim = t.limits + tbl * 16;
    l = data >= lim[7] ? 8 : 0;
    l += data >= lim[l + 3] ? 4 : 0;
    l += data >= lim[l + 1] ? 2 : 0;
    l += data >= lim[l] ? 1 : 0;
  } else {
    const int32_t* maxcode = t.maxcode + tbl * 16;
    for (l = 0; l < 15; ++l) {  // length 16 always terminates
      if (static_cast<int32_t>(data >> (31 - l)) <= maxcode[l]) break;
    }
  }
  const int cat_len = l + 1;
  const int code = static_cast<int32_t>(data >> (32 - cat_len));
  const int idx = (t.vsm[tbl * 16 + l] + code) & 0xFF;
  const int sym_cat = t.huffval[tbl * 256 + idx];

  const int run_ac = sym_cat >> 4;
  const int cat_ac = sym_cat & 0xF;
  const int cat = is_dc ? sym_cat : cat_ac;
  Symbol s;
  // EOB fills the data unit, ZRL skips 16
  s.run = is_dc ? 0 : (cat_ac == 0 ? (run_ac == 15 ? 15 : 63 - z) : run_ac);
  s.length = cat_len + cat;
  s.value = 0;
  if (NEED_VALUE && cat > 0) {
    // T.81 F.12 EXTEND; a garbage category (> 16) keeps the shifts defined
    const uint32_t off_u =
        (data << (cat_len & 31)) >> ((32 - cat) & 31);
    const int32_t off = static_cast<int32_t>(off_u);
    const int cat_c = cat < 31 ? cat : 31;
    const int32_t one = static_cast<int32_t>(1u << cat_c);
    const int32_t half = one >> 1;
    s.value = off < half
        ? static_cast<int32_t>(off_u - static_cast<uint32_t>(one) + 1u)
        : off;
  }
  return s;
}

// Commit a symbol of `run` skipped positions into the (c, z) state.
__device__ inline void advance_cz(int& c, int& z, int run, int du_per_mcu) {
  z += run + 1;
  if (z >= 64) {
    z = 0;
    c += 1;
    if (c >= du_per_mcu) c = 0;
  }
}

}  // namespace jpeggpu
