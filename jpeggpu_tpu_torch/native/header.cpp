// Native header pass of a baseline JPEG.
//
// All of one stream's header work in one pass over the buffer, on the
// calling thread, as the reference host parser does (reader.cpp:596-672):
// the marker loop (fill bytes before a marker skipped, B.1.1.2; APPn, COM
// and unknown segments skipped), SOF0/SOF1, DQT (zig-zag to natural, a
// redefinition ignored once a scan has locked the table), DRI, DHT (each
// table derived into its canonical decode arrays, reader.cpp:186-224), SOS
// (the scan's MCU geometry) and each scan body's segment walk (walk.cpp's,
// called in-process). The checks, their order and the derivation are those
// of reader.py's Python parser, which a machine without a C++ compiler
// takes; reader.py maps each error code below to the exception class and
// message that parser raises for the same condition.
//
// Build: c++ -O3 -shared -fPIC destuff.cpp walk.cpp header.cpp
//        -o libjpeggpu_host.so

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" int64_t jpeggpu_segment_walk(const uint8_t* body, int64_t size,
                                        int64_t cap, int64_t* seg_raw,
                                        int64_t* seg_stuffed,
                                        int64_t* scan_end);

namespace {

// Returned as they are: the stream parsed (kOk); a scan body holds more
// restart segments than its header allows, so the stream goes to the
// Python parser and its numpy walk (kFallback); the segment arrays are too
// small, call again with room for size / 2 + 4 segments (kNeedSegments).
constexpr int64_t kOk = 0;
constexpr int64_t kFallback = 1;
constexpr int64_t kNeedSegments = 2;

// Errors, returned negated. The order is reader.py's _NATIVE_ERRORS.
enum Error : int64_t {
  kInvalid = 1,          // InvalidJpeg, default message
  kIncomplete,           // IncompleteBitstream, default message
  kEndOfStream,          // "unexpected end of stream"
  kTooFewForMarker,      // "too few bytes for marker"
  kBadMarkerByte,        // "invalid marker byte 0x%02x" (arg)
  kPrecision,            // "sample precision %d, only 8 supported" (arg)
  kBadSize,              // "invalid size"
  kZeroComponents,       // "zero components"
  kTooManyComponents,    // "too many components: %d" (arg)
  kBadSubsampling,       // "invalid subsampling factor"
  kBadQtableIndex,       // "invalid quantization table index"
  kBadHuffClass,         // "invalid Huffman table class"
  kBadHuffIndex,         // "Huffman table index must be in [0,3]"
  kTooManyValues,        // "too many values"
  kOverfull,             // "overfull Huffman code space"
  kBadDqt,               // "invalid DQT precision or id"
  kDqt16,                // "16-bit quantization table"
  kRedefinedDri,         // "redefined restart interval"
  kSosBeforeSof,         // "SOS before SOF"
  kBadScanComponents,    // "invalid number of scan components"
  kTooManyScans,         // "too many scans (component redefinition)"
  kBadSelector,          // "invalid component selector"
  kBadOrder,             // "invalid component order in scan"
  kTwoScans,             // "component defined in two scans"
  kHuffIdBounds,         // "Huffman table id out of bounds"
  kUndefinedDc,          // "undefined DC table"
  kUndefinedAc,          // "undefined AC table"
  kUndefinedQtable,      // "undefined quantization table"
  kTooManyDataUnits,     // "too many data units in MCU"
  kNoEoi,                // "no end-of-image marker"
  kMissingSoi,           // "missing SOI"
  kMultipleSof,          // "multiple SOF"
  kUnsupportedSof,       // "unsupported JPEG type <name>" (arg: the marker)
  kNoSof,                // "no SOF"
  kComponentNotInScan,   // "component %d not defined in any scan" (arg)
};

struct Stop {
  int64_t rc;
  int64_t arg;
};

[[noreturn]] void fail(Error e, int64_t arg = 0) { throw Stop{-e, arg}; }

constexpr int kMaxComponents = 4;
constexpr int kMaxScans = 4;
constexpr int kSlots = 8;  // [dc0, ac0, dc1, ac1, ...]
constexpr int kLookupBits = 8;
constexpr int kAlphabet = 256;

// The output layout, as native/__init__.py reads it: globals, then
// kMaxComponents records of kCompW, then kMaxScans records of kScanW.
enum Global {
  kSizeX, kSizeY, kNumComponents, kSsMaxX, kSsMaxY, kRestartInterval,
  kNumScans, kNumPool, kNumMarkers, kErrorArg, kGlobals
};
// a component: id, qtable_idx, size_x, size_y, ss_x, ss_y
constexpr int kCompW = 6;
// a scan: begin, end, num_data_units_in_mcu, num_mcus_x, num_mcus_y,
// num_segments, the first segment's index, number of components, the pool
// index of each of the 8 slots, then per component kScanCompW fields
// (component_idx, dc_table_id, ac_table_id, mcu_size_x, mcu_size_y,
// data_size_x, data_size_y, off_in_mcu, du_per_mcu)
constexpr int kScanHead = 8;
constexpr int kScanCompW = 9;
constexpr int kScanW = kScanHead + kSlots + kMaxComponents * kScanCompW;
constexpr int kHeaderLen =
    kGlobals + kMaxComponents * kCompW + kMaxScans * kScanW;

// One pool entry: tables.HuffmanTable's arrays, as the numpy record
// native.HUFF_DTYPE lays them out.
struct Table {
  int32_t maxcode[16];
  int32_t valptr_sub_mincode[16];
  uint8_t huffval[kAlphabet];
  uint8_t lut_value[1 << kLookupBits];
  uint8_t lut_nbits[1 << kLookupBits];
  int32_t num_symbols;
  int32_t saturated;
};
static_assert(sizeof(Table) == 904, "native.HUFF_DTYPE's layout");
constexpr int kPoolSize = 1 + kMaxScans * kSlots;  // at most 8 new a scan

// T.81 Figure A.6: the raster index of zig-zag index i.
constexpr uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

void empty_table(Table& t) {
  std::fill(t.maxcode, t.maxcode + 16, -1);
  std::memset(t.valptr_sub_mincode, 0, sizeof t.valptr_sub_mincode);
  std::memset(t.huffval, 0, sizeof t.huffval);
  std::memset(t.lut_value, 0, sizeof t.lut_value);
  std::memset(t.lut_nbits, 0, sizeof t.lut_nbits);
  t.num_symbols = 0;
  t.saturated = 0;
}

// tables.build_huffman_table: canonical codes in ascending length, then
// ascending value order.
void derive_table(const uint8_t* counts, const uint8_t* values, int total,
                  Table& t) {
  empty_table(t);
  std::memcpy(t.huffval, values, total);
  t.num_symbols = total;
  int64_t code = 0;
  int idx = 0;
  for (int l = 0; l < 16; ++l) {
    const int n = counts[l];
    if (n) {
      if (code + n - 1 >= (int64_t{1} << (l + 1))) fail(kOverfull);
      t.valptr_sub_mincode[l] = static_cast<int32_t>(idx - code);
      if (l + 1 <= kLookupBits) {
        const int shift = kLookupBits - (l + 1);
        for (int j = 0; j < n; ++j) {
          const int64_t lo = (code + j) << shift;
          std::memset(t.lut_value + lo, t.huffval[idx + j], size_t{1} << shift);
          std::memset(t.lut_nbits + lo, l + 1, size_t{1} << shift);
        }
      }
      idx += n;
      code += n;
      t.maxcode[l] = static_cast<int32_t>(code - 1);
      if (code - 1 == (int64_t{1} << (l + 1)) - 1) t.saturated = 1;
    }
    code <<= 1;
  }
}

struct Parser {
  const uint8_t* buf;
  int64_t size;
  int64_t pos = 0;
  int64_t* hdr;
  uint8_t* qtables;
  Table* pool;
  int64_t* seg_raw;
  int64_t* seg_stuffed;
  int64_t seg_cap;
  int32_t* markers;
  int64_t marker_cap;

  bool found_sof = false;
  bool qtable_defined[4] = {};
  bool qtable_locked[4] = {};
  bool huff_defined[kSlots] = {};
  bool comps_seen[kMaxComponents] = {};
  Table cur_huff[kSlots] = {};
  // the pool entry of a slot's table, -1: none yet
  int64_t cur_pool[kSlots] = {-1, -1, -1, -1, -1, -1, -1, -1};
  int64_t num_components = 0;
  int64_t num_scans = 0;
  int64_t num_pool = 1;  // entry 0: the empty table of an undefined slot
  int64_t num_markers = 0;
  int64_t segments_used = 0;

  int64_t remaining() const { return size - pos; }
  int u8() {
    if (remaining() < 1) fail(kEndOfStream);
    return buf[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }
  int64_t* comp(int64_t i) { return hdr + kGlobals + i * kCompW; }
  int64_t* scan(int64_t s) {
    return hdr + kGlobals + kMaxComponents * kCompW + s * kScanW;
  }

  int read_marker() {
    if (remaining() < 2) fail(kTooFewForMarker);
    const int ff = u8();
    if (ff != 0xFF) fail(kBadMarkerByte, ff);
    int m = u8();
    while (m == 0xFF) m = u8();  // B.1.1.2: fill bytes
    return m;
  }

  void read_sof() {
    if (remaining() < 2) fail(kInvalid);
    const int length = u16();
    if (length < 2) fail(kInvalid);
    if (remaining() < length - 2) fail(kIncomplete);
    const int precision = u8();
    if (precision != 8) fail(kPrecision, precision);  // reader.cpp:95-99
    const int num_lines = u16();
    const int num_samples = u16();
    if (num_lines == 0 || num_samples == 0) fail(kBadSize);
    hdr[kSizeX] = num_samples;
    hdr[kSizeY] = num_lines;
    const int n = u8();
    if (n == 0) fail(kZeroComponents);
    if (n > kMaxComponents) fail(kTooManyComponents, n);  // reader.cpp:114-117
    num_components = n;
    if (remaining() < 3 * n) fail(kIncomplete);
    int64_t ss_max_x = 0, ss_max_y = 0;
    for (int i = 0; i < n; ++i) {
      int64_t* c = comp(i);
      c[0] = u8();
      const int sf = u8();
      int ss_x = sf >> 4, ss_y = sf & 0xF;
      if (ss_x < 1 || ss_x > 4 || ss_y < 1 || ss_y > 4) fail(kBadSubsampling);
      if (n == 1) ss_x = ss_y = 1;  // factors ignored (reader.cpp:147-153)
      c[4] = ss_x;
      c[5] = ss_y;
      const int qi = u8();
      if (qi > 3) fail(kBadQtableIndex);
      c[1] = qi;
      ss_max_x = std::max<int64_t>(ss_max_x, ss_x);
      ss_max_y = std::max<int64_t>(ss_max_y, ss_y);
    }
    for (int i = 0; i < n; ++i) {  // A.1.1 component size
      int64_t* c = comp(i);
      c[2] = (num_samples * c[4] + ss_max_x - 1) / ss_max_x;
      c[3] = (num_lines * c[5] + ss_max_y - 1) / ss_max_y;
    }
    hdr[kSsMaxX] = ss_max_x;
    hdr[kSsMaxY] = ss_max_y;
    found_sof = true;
  }

  void read_dht() {
    if (remaining() < 2) fail(kInvalid);
    int64_t left = u16() - 2;
    if (remaining() < left) fail(kInvalid);
    while (left > 0) {
      const int index = u8();
      left -= 1;
      const int table_class = index >> 4, th = index & 0xF;
      if (table_class > 1) fail(kBadHuffClass);
      if (th > 3) fail(kBadHuffIndex);  // reader.cpp:250-253
      if (left < 16) fail(kInvalid);
      const uint8_t* counts = buf + pos;
      pos += 16;
      left -= 16;
      int count = 0;
      for (int l = 0; l < 16; ++l) count += counts[l];
      if (left < count) fail(kInvalid);
      if (count > kAlphabet) fail(kTooManyValues);
      const uint8_t* values = buf + pos;
      pos += count;
      left -= count;
      const int slot = th * 2 + table_class;
      derive_table(counts, values, count, cur_huff[slot]);
      cur_pool[slot] = -1;
      huff_defined[slot] = true;
    }
  }

  void read_dqt() {
    if (remaining() < 2) fail(kInvalid);
    int64_t left = u16() - 2;
    if (remaining() < left) fail(kInvalid);
    while (left > 0) {
      const int info = u8();
      left -= 1;
      const int precision = info >> 4, tid = info & 0xF;
      if (precision > 1 || tid > 3) fail(kBadDqt);
      if (precision != 0) fail(kDqt16);  // reader.cpp:517-520
      if (left < 64) fail(kInvalid);
      const uint8_t* vals = buf + pos;
      pos += 64;
      left -= 64;
      qtable_defined[tid] = true;
      // a scan already decodes with this table (cf. reader.cpp:524-544)
      if (!qtable_locked[tid]) {
        for (int i = 0; i < 64; ++i) qtables[tid * 64 + kNatural[i]] = vals[i];
      }
    }
  }

  void read_dri() {
    if (remaining() < 2) fail(kInvalid);
    const int64_t left = u16() - 2;
    if (remaining() < left) fail(kInvalid);
    const int rsti = u16();
    const int64_t ri = hdr[kRestartInterval];
    if (ri && ri != rsti) fail(kRedefinedDri);  // reader.cpp:563-569
    hdr[kRestartInterval] = rsti;
  }

  void skip_segment() {
    if (remaining() < 2) fail(kInvalid);
    const int length = u16();
    if (length < 2) fail(kInvalid);
    if (remaining() < length - 2) fail(kIncomplete);
    pos += length - 2;
  }

  void read_sos() {
    if (!found_sof) fail(kSosBeforeSof);
    if (remaining() < 3) fail(kInvalid);
    const int length = u16();
    if (length < 3) fail(kInvalid);
    const int n_sc = u8();
    if (n_sc < 1 || n_sc > 4) fail(kBadScanComponents);
    if (num_scans >= kMaxScans) fail(kTooManyScans);
    if (length - 3 != 2 * n_sc + 3) fail(kInvalid);
    if (remaining() < 2 * n_sc + 3) fail(kIncomplete);
    int64_t* s = scan(num_scans);
    int64_t* sc = s + kScanHead + kSlots;
    for (int k = 0; k < n_sc; ++k, sc += kScanCompW) {
      const int selector = u8();
      const int acdc = u8();
      const int id_dc = acdc >> 4, id_ac = acdc & 0xF;
      int comp_idx = -1;
      for (int i = 0; i < num_components; ++i) {
        if (comp(i)[0] == selector) {
          comp_idx = i;
          break;
        }
      }
      if (comp_idx == -1) fail(kBadSelector);
      // A.2: component order in scan follows frame order (reader.cpp:369-372)
      if (k > 0 && comp_idx <= sc[-kScanCompW]) fail(kBadOrder);
      if (comps_seen[comp_idx]) fail(kTwoScans);
      comps_seen[comp_idx] = true;
      if (id_dc > 3 || id_ac > 3) fail(kHuffIdBounds);
      if (!huff_defined[id_dc * 2]) fail(kUndefinedDc);
      if (!huff_defined[id_ac * 2 + 1]) fail(kUndefinedAc);
      const int64_t qi = comp(comp_idx)[1];
      if (!qtable_defined[qi]) fail(kUndefinedQtable);
      qtable_locked[qi] = true;
      sc[0] = comp_idx;
      sc[1] = id_dc;
      sc[2] = id_ac;
    }

    const bool interleaved = n_sc > 1;
    int64_t du_in_mcu = 0, mcus_x = 0, mcus_y = 0;
    sc = s + kScanHead + kSlots;
    for (int k = 0; k < n_sc; ++k, sc += kScanCompW) {
      const int64_t* c = comp(sc[0]);
      sc[3] = interleaved ? 8 * c[4] : 8;
      sc[4] = interleaved ? 8 * c[5] : 8;
      sc[5] = (c[2] + sc[3] - 1) / sc[3] * sc[3];
      sc[6] = (c[3] + sc[4] - 1) / sc[4] * sc[4];
      mcus_x = sc[5] / sc[3];
      mcus_y = sc[6] / sc[4];
      sc[7] = du_in_mcu;
      sc[8] = interleaved ? c[4] * c[5] : 1;
      du_in_mcu += sc[8];
    }
    if (du_in_mcu > 10) fail(kTooManyDataUnits);  // B.2.3 (reader.cpp:424-428)
    u8();  // spectral start
    u8();  // spectral end
    u8();  // successive approximation

    // the 8 slots' tables at SOS time: each definition enters the pool once
    for (int slot = 0; slot < kSlots; ++slot) {
      if (huff_defined[slot] && cur_pool[slot] < 0) {
        pool[num_pool] = cur_huff[slot];
        cur_pool[slot] = num_pool++;
      }
      s[kScanHead + slot] = huff_defined[slot] ? cur_pool[slot] : 0;
    }

    // the segment walk (reader.cpp:443-489); segments the header allows
    const int64_t begin = pos;
    const int64_t body_size = size - begin;
    const int64_t ri = hdr[kRestartInterval];
    const int64_t num_mcus = mcus_x * mcus_y;
    const int64_t cap =
        std::min(ri ? (num_mcus + ri - 1) / ri : 1, body_size / 2 + 1);
    const int64_t room = std::min(cap, seg_cap - segments_used);
    int64_t scan_end = 0;
    const int64_t n = jpeggpu_segment_walk(
        buf + begin, body_size, room, seg_raw + 2 * segments_used,
        seg_stuffed + segments_used, &scan_end);
    if (n == -1) fail(kNoEoi);
    if (n < 0) throw Stop{room < cap ? kNeedSegments : kFallback, 0};
    s[0] = begin;
    s[1] = begin + scan_end;
    s[2] = du_in_mcu;
    s[3] = mcus_x;
    s[4] = mcus_y;
    s[5] = n;
    s[6] = segments_used;
    s[7] = n_sc;
    segments_used += n;
    pos = begin + scan_end;
    ++num_scans;
  }

  void run() {
    if (read_marker() != 0xD8) fail(kMissingSoi);
    while (true) {
      const int m = read_marker();
      if (num_markers < marker_cap) markers[num_markers] = m;
      ++num_markers;
      if (m == 0xC0 || m == 0xC1) {  // SOF0, SOF1
        if (found_sof) fail(kMultipleSof);
        read_sof();
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC) {  // SOF2-3, SOF5-7, SOF9-11, SOF13-15
        fail(kUnsupportedSof, m);
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xD9) {  // EOI
        break;
      } else if (m == 0xDA) {
        read_sos();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        read_dri();
      } else {
        skip_segment();
      }
    }
    if (!found_sof) fail(kNoSof);
    for (int c = 0; c < num_components; ++c) {
      if (!comps_seen[c]) fail(kComponentNotInScan, c);
    }
  }
};

}  // namespace

extern "C" {

// Parses buf[0, size) into out, laid out as native/__init__.py reads it:
// header int64[kHeaderLen] (the globals, components and scans above), the
// quantization tables in natural order uint8[4 * 64], the Huffman tables
// the scans snapshot Table[kPoolSize] (entry 0 the empty table), the walk's
// segments int64[seg_cap * 2] and stuffed-pair counts int64[seg_cap] (each
// scan's from its first segment's index on), and the first marker_cap
// markers read after SOI int32[marker_cap], all of them counted. Returns
// kOk, kFallback, kNeedSegments, or an error negated, with its argument in
// header[kErrorArg]; the counts are written in every case.
int64_t jpeggpu_parse(const uint8_t* buf, int64_t size, void* out,
                      int64_t seg_cap, int64_t marker_cap) {
  auto* header = static_cast<int64_t*>(out);
  auto* qtables = reinterpret_cast<uint8_t*>(header + kHeaderLen);
  auto* pool = reinterpret_cast<Table*>(qtables + 4 * 64);
  auto* seg_raw = reinterpret_cast<int64_t*>(pool + kPoolSize);
  int64_t* seg_stuffed = seg_raw + 2 * seg_cap;
  auto* markers = reinterpret_cast<int32_t*>(seg_stuffed + seg_cap);
  std::fill(header, header + kHeaderLen, 0);
  std::memset(qtables, 0, 4 * 64);
  Parser p{buf,     size,        0,           header,  qtables, pool,
           seg_raw, seg_stuffed, seg_cap,     markers, marker_cap};
  empty_table(p.pool[0]);
  int64_t rc = kOk;
  try {
    p.run();
  } catch (const Stop& stop) {
    rc = stop.rc;
    header[kErrorArg] = stop.arg;
  }
  header[kNumComponents] = p.num_components;
  header[kNumScans] = p.num_scans;
  header[kNumPool] = p.num_pool;
  header[kNumMarkers] = p.num_markers;
  return rc;
}

}  // extern "C"
