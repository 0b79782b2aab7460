// Native host-side destuffer.
//
// Removes 0xFF00 byte stuffing and restart markers from a JPEG scan body
// and writes each restart segment into its subsequence-aligned (128-byte,
// zero-padded) window of the device word layout, big-endian words swapped
// to host order: the same output the device destuff stage produces (cf.
// reference decode_destuff.cu:75-113, reimplemented for the host, where it
// overlaps the previous image's device decode).
//
// One pass on the calling thread, memchr-driven (like the reference host
// parser's segment walk, reader.cpp:450-487), each window swapped while it
// is in cache. Threads do not pay here: at 12 MP one thread destuffs a
// frame in about a millisecond, and starting and joining threads costs as
// much and adds their scheduling to every call (PERF.md, §6).
//
// Build: c++ -O3 -shared -fPIC destuff.cpp walk.cpp -o libjpeggpu_host.so

#include <cstdint>
#include <cstring>

namespace {
constexpr int kSubseqBytes = 128;
constexpr int kSubseqWords = kSubseqBytes / 4;

// Destuff one restart segment into [dst, dst_end): the src span contains
// no restart markers (the host parser's segment walk already split on
// them), only 0xFF00 stuffing. Returns the end of what was written, or
// nullptr if dst capacity would be exceeded.
uint8_t* destuff_segment(const uint8_t* src, const uint8_t* end, uint8_t* dst,
                         uint8_t* dst_end) {
  while (src < end) {
    const uint8_t* ff =
        static_cast<const uint8_t*>(memchr(src, 0xFF, end - src));
    if (ff == nullptr) ff = end;
    int64_t run = ff - src;
    if (dst + run > dst_end) return nullptr;
    memcpy(dst, src, run);
    dst += run;
    src = ff;
    if (src >= end) break;
    if (src + 1 >= end) break;  // dangling 0xFF at span end
    if (src[1] == 0x00) {
      if (dst + 1 > dst_end) return nullptr;
      *dst++ = 0xFF;
      src += 2;
    } else {
      break;  // marker inside span: parser disagreement; stop this segment
    }
  }
  return dst;
}
}  // namespace

extern "C" {

// Destuff scan bytes straight into the padded device word layout `out`
// (out_words uint32, any content beforehand: it is written whole).
// seg_raw holds each segment's stuffed byte span (start, end pairs,
// relative to `scan`, end excluding the restart marker) as discovered by
// the host parser's segment walk (walk.cpp, or reader.py's numpy walk);
// seg_sub_offset each segment's first subsequence. Segment s fills the window
// [seg_sub_offset[s], seg_sub_offset[s + 1]) subsequences (the last one up
// to num_subseq): its destuffed bytes, zeros to the window's end, then each
// word swapped from big-endian to host order; words outside every window
// are zeroed. Returns the number of segments destuffed, or -1 if any
// segment would overflow its window (the caller then takes the numpy
// destuffer, which clamps).
int64_t jpeggpu_destuff_words(const uint8_t* scan, int64_t scan_size,
                              const int64_t* seg_raw,
                              const int32_t* seg_sub_offset,
                              int64_t num_segments, uint32_t* out,
                              int64_t num_subseq, int64_t out_words) {
  if (num_subseq * kSubseqWords > out_words) return -1;
  int64_t first = num_segments > 0 ? seg_sub_offset[0] : num_subseq;
  if (first < 0 || first > num_subseq) return -1;
  // words before the first window and past the last one
  memset(out, 0, first * kSubseqBytes);
  memset(out + num_subseq * kSubseqWords, 0,
         (out_words - num_subseq * kSubseqWords) * 4);
  auto* bytes = reinterpret_cast<uint8_t*>(out);
  for (int64_t s = 0; s < num_segments; ++s) {
    int64_t lo = seg_raw[2 * s], hi = seg_raw[2 * s + 1];
    int64_t sub0 = seg_sub_offset[s];
    int64_t sub1 = (s + 1 < num_segments) ? seg_sub_offset[s + 1]
                                          : num_subseq;
    if (lo < 0 || hi > scan_size || lo > hi || sub0 < 0 || sub1 < sub0 ||
        sub1 > num_subseq)
      return -1;
    uint8_t* win = bytes + sub0 * kSubseqBytes;
    uint8_t* win_end = bytes + sub1 * kSubseqBytes;
    uint8_t* end = destuff_segment(scan + lo, scan + hi, win, win_end);
    if (end == nullptr) return -1;
    memset(end, 0, win_end - end);
    for (int64_t w = sub0 * kSubseqWords; w < sub1 * kSubseqWords; ++w)
      out[w] = __builtin_bswap32(out[w]);
  }
  return num_segments;
}

}  // extern "C"
