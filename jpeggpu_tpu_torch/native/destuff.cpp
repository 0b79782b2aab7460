// Native host-side destuffer.
//
// Removes 0xFF00 byte stuffing and restart markers from a JPEG scan body
// and compacts each restart segment into the subsequence-aligned (128-byte,
// zero-padded) device layout — the same output the device destuff stage
// produces (cf. reference decode_destuff.cu:75-113, reimplemented for the
// host, where it overlaps the previous image's device decode).
//
// Single pass, memchr-driven (like the reference host parser's segment walk,
// reader.cpp:450-487); segments destuff in parallel across threads
// (jpeggpu_destuff_seg below).
//
// Build: c++ -O3 -shared -fPIC -pthread destuff.cpp -o libjpeggpu_host.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {
constexpr int kSubseqBytes = 128;

// Destuff one restart segment: src span contains no restart markers (the
// host parser's segment walk already split on them), only 0xFF00 stuffing.
// Returns false if dst capacity would be exceeded.
bool destuff_segment(const uint8_t* src, const uint8_t* end, uint8_t* dst,
                     uint8_t* dst_end) {
  while (src < end) {
    const uint8_t* ff =
        static_cast<const uint8_t*>(memchr(src, 0xFF, end - src));
    if (ff == nullptr) ff = end;
    int64_t run = ff - src;
    if (dst + run > dst_end) return false;
    memcpy(dst, src, run);
    dst += run;
    src = ff;
    if (src >= end) break;
    if (src + 1 >= end) break;  // dangling 0xFF at span end
    if (src[1] == 0x00) {
      if (dst + 1 > dst_end) return false;
      *dst++ = 0xFF;
      src += 2;
    } else {
      break;  // marker inside span: parser disagreement; stop this segment
    }
  }
  return true;
}
}  // namespace

extern "C" {

// Destuff scan bytes into `out` (caller-zeroed, num_subseq*128 bytes).
// seg_sub_offset: per-segment subsequence offset (host-parsed, num_segments
// entries). Returns the number of segments actually consumed, or -1 if the
// output layout would be violated (inconsistent with the parsed geometry).
int64_t jpeggpu_destuff(const uint8_t* scan, int64_t scan_size,
                        const int32_t* seg_sub_offset, int64_t num_segments,
                        uint8_t* out, int64_t out_size) {
  if (num_segments <= 0) return 0;
  int64_t seg = 0;
  uint8_t* dst = out + static_cast<int64_t>(seg_sub_offset[0]) * kSubseqBytes;
  const uint8_t* src = scan;
  const uint8_t* end = scan + scan_size;
  const uint8_t* out_end = out + out_size;
  while (src < end) {
    const uint8_t* ff =
        static_cast<const uint8_t*>(memchr(src, 0xFF, end - src));
    if (ff == nullptr) ff = end;
    int64_t run = ff - src;
    if (dst + run > out_end) return -1;
    memcpy(dst, src, run);
    dst += run;
    src = ff;
    if (src >= end) break;
    // src points at 0xFF; look at the byte after it
    if (src + 1 >= end) break;  // dangling 0xFF: treated as scan end
    uint8_t m = src[1];
    if (m == 0x00) {
      if (dst + 1 > out_end) return -1;
      *dst++ = 0xFF;  // stuffed literal 0xFF
      src += 2;
    } else if (m >= 0xD0 && m <= 0xD7) {
      // restart marker: next segment starts subsequence-aligned
      ++seg;
      if (seg >= num_segments) return seg;  // trailing marker, done
      dst = out + static_cast<int64_t>(seg_sub_offset[seg]) * kSubseqBytes;
      src += 2;
    } else {
      break;  // any other marker terminates the scan
    }
  }
  return seg + 1;
}

// Segment-parallel destuff: seg_raw holds each segment's stuffed byte span
// (start, end pairs, relative to `scan`, end excluding the restart marker) as
// discovered by the host parser's vectorized segment walk (reader.py). The
// segments are independent — each one starts subsequence-aligned in the
// output — so they are sheared across `num_threads` workers, each taking a
// contiguous run of segments balanced by input bytes. Returns the number of
// segments destuffed, or -1 if any segment would overflow its output window.
int64_t jpeggpu_destuff_seg(const uint8_t* scan, int64_t scan_size,
                            const int64_t* seg_raw,
                            const int32_t* seg_sub_offset,
                            int64_t num_segments, uint8_t* out,
                            int64_t out_size, int32_t num_threads) {
  if (num_segments <= 0) return 0;
  const int64_t total_subseq = out_size / kSubseqBytes;
  auto worker = [&](int64_t seg_lo, int64_t seg_hi, std::atomic<bool>* ok) {
    for (int64_t s = seg_lo; s < seg_hi; ++s) {
      int64_t lo = seg_raw[2 * s], hi = seg_raw[2 * s + 1];
      if (lo < 0 || hi > scan_size || lo > hi) { ok->store(false); return; }
      int64_t sub0 = seg_sub_offset[s];
      int64_t sub1 = (s + 1 < num_segments) ? seg_sub_offset[s + 1]
                                            : total_subseq;
      if (sub0 < 0 || sub1 < sub0 || sub1 > total_subseq) {
        ok->store(false);
        return;
      }
      if (!destuff_segment(scan + lo, scan + hi, out + sub0 * kSubseqBytes,
                           out + sub1 * kSubseqBytes)) {
        ok->store(false);
        return;
      }
    }
  };
  std::atomic<bool> ok(true);
  if (num_threads <= 1 || num_segments == 1) {
    worker(0, num_segments, &ok);
    return ok.load() ? num_segments : -1;
  }
  // balance by input bytes: thread t takes segments while its share of the
  // total byte count lasts
  int64_t total_bytes = 0;
  for (int64_t s = 0; s < num_segments; ++s)
    total_bytes += seg_raw[2 * s + 1] - seg_raw[2 * s];
  std::vector<std::thread> threads;
  int64_t s = 0, acc = 0, t = 0;
  for (; t < num_threads && s < num_segments; ++t) {
    int64_t target = total_bytes * (t + 1) / num_threads;
    int64_t lo = s;
    while (s < num_segments &&
           (acc < target || s == lo)) {
      acc += seg_raw[2 * s + 1] - seg_raw[2 * s];
      ++s;
    }
    threads.emplace_back(worker, lo, s, &ok);
  }
  for (auto& th : threads) th.join();
  return ok.load() ? num_segments : -1;
}

// In-place big-endian -> host byte-order conversion of 32-bit words.
// The destuffed layout is consumed by the device bit reader as uint32 words
// holding the stream's bytes MSB-first (ops/huffman.py _load32); converting
// here (parallel, one pass) replaces a three-copy numpy conversion chain on
// the Python side.
void jpeggpu_bswap32(uint32_t* buf, int64_t num_words, int32_t num_threads) {
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) buf[i] = __builtin_bswap32(buf[i]);
  };
  if (num_threads <= 1 || num_words < (1 << 18)) {
    worker(0, num_words);
    return;
  }
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    int64_t lo = num_words * t / num_threads;
    int64_t hi = num_words * (t + 1) / num_threads;
    if (lo < hi) threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
