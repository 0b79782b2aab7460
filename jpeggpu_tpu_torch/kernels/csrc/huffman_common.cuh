// Shared device code of the three entropy-decode kernels (subseq_pass.cu,
// decode_write.cu, emit_pass.cu): a register bit reader over the destuffed
// big-endian word stream and the decode of one symbol.
//
// - next_symbol: one shared-memory load resolves a symbol whose code has at
//   most kSymBits = 10 bits, from the per-scan symbol table that
//   ops/huffman.py build_symbol_table makes on the host: int16 entry
//   [slot << 10 | next 10 bits] holds the symbol of that slot's class (DC
//   for even slots, AC for odd ones: slot = table id * 2 + class) as length
//   | category << 5 | run << 10 | EOB << 14 | escape << 15.
// - decode_symbol_in: an escaped symbol (a longer code, or a garbage DC
//   category whose symbol reaches 32 bits) takes the canonical-limit search
//   (four dependent compares) or the maxcode walk, then the vsm and huffval
//   lookups, over the packed tables (HuffTables) of the named slots, which
//   load_symbol_table copies into shared memory beside the symbol table.
//
// Why 10 bits: the table of 8 slots x 2^10 entries x 2 bytes is 16 KB, the
// most a block may hold; a block copies only the slots its scan names (4
// on a three-component scan with two table ids: 8 KB, plus 1.5 KB of their
// escape tables). On chip_smoke.py's 12 MP quality-90 image (it counts
// them), 1.25% of the symbols have codes longer than 10 bits, against
// 1.74% at 9 and 3.08% at 8 (none on its quality-30 image), and since a
// warp waits for the slowest of its 32 lanes, an escape rate r costs the
// search in 1 - (1 - r)^32 of a warp's iterations: 33% at 10 bits, 43% at
// 9, 63% at 8.
//
// Semantics follow the plain PyTorch version in ops/huffman.py (_load32,
// _decode_symbol, _symbol_step; _decode_symbol_table models next_symbol)
// statement for statement, including what it does on garbage: every shift
// count is masked or clamped as there, and arithmetic that may wrap is done
// unsigned.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jpeggpu {

constexpr int kTables = 8;        // 4 DC + 4 AC, slot = id * 2 + class
constexpr int kMaxDuPerMcu = 10;  // T.81 B.2.3
constexpr int kEntropyBlock = 32; // one warp: each thread walks its own stream
constexpr int kSubseqBits = 1024; // bits of one subsequence (one lane)

// the symbol table (ops/huffman.py SYMTAB_*)
constexpr int kSymBits = 10;
constexpr int kSymEntries = 1 << kSymBits;
constexpr uint32_t kSymEob = 1u << 14;
constexpr uint32_t kSymEsc = 1u << 15;

struct alignas(16) HuffTables {
  int32_t maxcode[kTables * 16];   // largest code of length l+1, or -1
  int32_t vsm[kTables * 16];       // valptr - mincode per length
  uint32_t limits[kTables * 16];   // first left-aligned value with a longer code
  uint8_t huffval[kTables * 256];  // symbol values in canonical order
};

// The symbol table of the slots the scan names, and their packed tables
// for the escape path, in shared memory.
struct alignas(16) SymbolTable {
  uint16_t entry[kTables * kSymEntries];  // 16 KB; unnamed slots unfilled
  HuffTables esc;                         // named slots only
};

// Cooperative copy of the named slots into shared memory, 16 bytes a
// thread per load, all loads of the block issued together. `pairs` holds
// the MCU's (DC, AC) slot pairs, 6 bits a data unit, as the wrapper packs
// them from the scan geometry (a kernel argument, so the copy waits on no
// load of its own). Every thread of the block must call it with
// blockDim.x == kEntropyBlock (it ends in a barrier).
template <bool FAST>
__device__ inline void load_symbol_table(
    SymbolTable& t, const int16_t* symtab, const int32_t* maxcode,
    const int32_t* vsm, const int32_t* limits, const int32_t* huffval,
    uint64_t pairs, int du_per_mcu) {
  unsigned named = 0;
  for (int i = 0; i < du_per_mcu; ++i) {
    named |= 1u << (pairs >> (6 * i) & 7) | 1u << (pairs >> (6 * i + 3) & 7);
  }
  constexpr int kVecs = kSymEntries * 2 / 16;  // uint4 per slot
  const uint4* src = reinterpret_cast<const uint4*>(symtab);
  uint4* dst = reinterpret_cast<uint4*>(t.entry);
  // the escape path's rows of the named slots: 16 int32 of limits (or
  // maxcode) and vsm, 256 huffval bytes from int32
  const int32_t* search = FAST ? limits : maxcode;
  int32_t* search_dst = FAST ? reinterpret_cast<int32_t*>(t.esc.limits)
                             : t.esc.maxcode;
  const int q = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kTables; ++s) {
    if (named >> s & 1u) {
#pragma unroll
      for (int k = 0; k < kVecs / kEntropyBlock; ++k) {
        const int i = s * kVecs + k * kEntropyBlock + q;
        dst[i] = __ldg(src + i);
      }
      if (q < 4) {
        reinterpret_cast<uint4*>(search_dst + s * 16)[q] =
            __ldg(reinterpret_cast<const uint4*>(search + s * 16) + q);
      } else if (q < 8) {
        reinterpret_cast<uint4*>(t.esc.vsm + s * 16)[q - 4] =
            __ldg(reinterpret_cast<const uint4*>(vsm + s * 16) + q - 4);
      }
#pragma unroll
      for (int h = q; h < 64; h += kEntropyBlock) {
        const uint4 v =
            __ldg(reinterpret_cast<const uint4*>(huffval + s * 256) + h);
        reinterpret_cast<uint32_t*>(t.esc.huffval + s * 256)[h] =
            (v.x & 255u) | (v.y & 255u) << 8 | (v.z & 255u) << 16 |
            (v.w & 255u) << 24;
      }
    }
  }
  __syncthreads();
}

// The data unit's place (c, z) in the MCU and its symbol-table slots, in
// registers. `off` is where the next symbol is looked up (the DC slot at
// z == 0, else the AC slot); the next data unit's slots are kept ready, so
// that advancing c reads no memory, takes no branch, and the next lookup
// waits for one compare and one select after the run is known.
struct UnitSlots {
  static_assert(6 * kMaxDuPerMcu <= 64, "slot pairs fit 64 bits");
  uint64_t pairs;
  int du_per_mcu;
  int c, z;
  int off, ac_off, next_dc_off, next_ac_off;

  __device__ static int dc_of(uint64_t pairs, int c) {
    return static_cast<int>(pairs >> (6 * c) & 7) << kSymBits;
  }
  __device__ static int ac_of(uint64_t pairs, int c) {
    return static_cast<int>(pairs >> (6 * c + 3) & 7) << kSymBits;
  }
  __device__ int after(int cc) const {
    return cc + 1 >= du_per_mcu ? 0 : cc + 1;
  }

  __device__ UnitSlots(uint64_t pairs_, int du, int c0, int z0)
      : pairs(pairs_), du_per_mcu(du), c(c0), z(z0) {
    ac_off = ac_of(pairs, c);
    off = z == 0 ? dc_of(pairs, c) : ac_off;
    next_dc_off = dc_of(pairs, after(c));
    next_ac_off = ac_of(pairs, after(c));
  }

  // Commit a symbol of `run` skipped positions: z += run + 1; at 64 the
  // next data unit (c wraps at du_per_mcu) starts with its DC symbol.
  __device__ void advance(int run) {
    const int zn = z + run + 1;
    const bool wrap = zn >= 64;
    off = wrap ? next_dc_off : ac_off;
    ac_off = wrap ? next_ac_off : ac_off;
    z = wrap ? 0 : zn;
    c = wrap ? after(c) : c;
    next_dc_off = dc_of(pairs, after(c));
    next_ac_off = ac_of(pairs, after(c));
  }
};

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

  // Advance by 0 < len < 32 bits. The refill's load is predicated on the
  // segment's end instead of branched around: in a warp some lane refills
  // in nearly every iteration, and a branch cost all 32 lanes a
  // reconvergence each time.
  __device__ void skip_predicated(int len) {
    buf <<= len;
    nbits -= len;
    if (nbits < 32) {
      buf |= static_cast<uint64_t>(ahead) << (32 - nbits);
      nbits += 32;
      ++next_word;
      const uint32_t* at = words + next_word;
      asm("{\n\t.reg .pred p;\n\tsetp.lt.s32 p, %1, %2;\n\t"
          "mov.b32 %0, 0;\n\t@p ld.global.nc.u32 %0, [%3];\n\t}"
          : "=r"(ahead)
          : "r"(next_word), "r"(word_end), "l"(at));
    }
  }
};

struct Symbol {
  int length;  // bits of the category code plus the value bits
  int run;     // zero coefficients skipped before this one
  int value;   // EXTENDed coefficient (0 where the symbol carries none)
};

// T.81 F.12 EXTEND of the `cat` value bits after a code of `cat_len` bits
// at the top of `data`; cat > 0. A garbage category (> 16) keeps the shifts
// defined.
__device__ inline int extend(uint32_t data, int cat_len, int cat) {
  const uint32_t off_u = (data << (cat_len & 31)) >> ((32 - cat) & 31);
  const int32_t off = static_cast<int32_t>(off_u);
  const int cat_c = cat < 31 ? cat : 31;
  const int32_t one = static_cast<int32_t>(1u << cat_c);
  const int32_t half = one >> 1;
  return off < half ? static_cast<int32_t>(off_u - static_cast<uint32_t>(one) + 1u)
                    : off;
}

// One symbol from the 32 left-aligned bits `data`, in table `tbl`, at
// zig-zag index `z` (0: DC). FAST is the canonical-limit search, exact for
// tables whose code space does not saturate; otherwise the maxcode walk.
template <bool FAST, bool NEED_VALUE>
__device__ inline Symbol decode_symbol_in(const HuffTables& t, int tbl,
                                          uint32_t data, int z) {
  const bool is_dc = z == 0;
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
  s.value = NEED_VALUE && cat > 0 ? extend(data, cat_len, cat) : 0;
  return s;
}

// The symbol at the reader by the symbol table, looked up at `off`
// (UnitSlots::off) for zig-zag index `z`, and the reader moved past it. One
// shared-memory load and about ten integer operations; an escaped symbol
// takes decode_symbol_in over the named slots' packed tables, and one of 32
// bits or more (only a garbage DC category) makes the reader seek to
// `base + p + length`. The reader moves before the caller's crossing test:
// a symbol that is not committed ends the lane's walk, so the reader is not
// read again.
template <bool FAST, bool NEED_VALUE>
__device__ inline Symbol next_symbol(const SymbolTable& t, BitReader& br,
                                     int off, int z, int base, int p) {
  const uint32_t data = br.peek();
  const uint32_t f = t.entry[off + (data >> (32 - kSymBits))];
  Symbol s;
  if (!(f & kSymEsc)) {
    s.length = f & 31u;
    // EOB fills the data unit; ZRL's run of 15 is in the entry
    s.run = (f & kSymEob) ? 63 - z : (f >> 10) & 15u;
    s.value = 0;
    if (NEED_VALUE) {
      const int cat = (f >> 5) & 31u;
      if (cat > 0) s.value = extend(data, s.length - cat, cat);
    }
    br.skip_predicated(s.length);
  } else {
    s = decode_symbol_in<FAST, NEED_VALUE>(t.esc, off >> kSymBits, data, z);
    if (s.length < 32) {
      br.skip_predicated(s.length);
    } else {
      br.seek(base + p + s.length);
    }
  }
  return s;
}

}  // namespace jpeggpu
