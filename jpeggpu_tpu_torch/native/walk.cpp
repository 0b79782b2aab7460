// Native segment walk of a scan body.
//
// Finds the end of a scan's entropy-coded data and splits it at its restart
// markers, as the reference host parser does (reader.cpp:443-489): one
// memchr-driven pass from the scan's first byte, on the calling thread. The
// rules are those of the numpy walk in reader.py, which a machine without a
// C++ compiler takes: after each 0xFF,
//   0x00         a stuffed pair, counted in the current segment;
//   RST0..RST7   the current segment ends at the 0xFF, the next one starts
//                two bytes on;
//   anything else, or no next byte (0xFF as the buffer's last byte): the
//                0xFF is the scan's end.
//
// Build: c++ -O3 -shared -fPIC destuff.cpp walk.cpp -o libjpeggpu_host.so

#include <cstdint>
#include <cstring>

extern "C" {

// Walks body[0, size). Writes segment s's stuffed span (start, end pairs,
// relative to body, end excluding the restart marker) to seg_raw[2 s],
// seg_raw[2 s + 1] and its count of stuffed 0xFF00 pairs to
// seg_stuffed[s], for at most cap segments, and the offset of the
// terminating 0xFF to *scan_end. Returns the number of segments; -1 if the
// body holds no terminator; -2 if it holds more than cap segments (the
// caller then takes the numpy walk).
int64_t jpeggpu_segment_walk(const uint8_t* body, int64_t size, int64_t cap,
                             int64_t* seg_raw, int64_t* seg_stuffed,
                             int64_t* scan_end) {
  const uint8_t* p = body;
  const uint8_t* const end = body + size;
  int64_t num_segments = 0;
  int64_t seg_start = 0;
  int64_t stuffed = 0;
  while (true) {
    const auto* ff = static_cast<const uint8_t*>(memchr(p, 0xFF, end - p));
    if (ff == nullptr) return -1;
    const int64_t off = ff - body;
    const bool rst = ff + 1 < end && ff[1] >= 0xD0 && ff[1] <= 0xD7;
    if (ff + 1 < end && ff[1] == 0x00) {
      ++stuffed;
    } else if (!rst) {  // the terminator
      if (num_segments >= cap) return -2;
      seg_raw[2 * num_segments] = seg_start;
      seg_raw[2 * num_segments + 1] = off;
      seg_stuffed[num_segments] = stuffed;
      *scan_end = off;
      return num_segments + 1;
    } else {
      if (num_segments + 1 >= cap) return -2;  // the terminator's needs one
      seg_raw[2 * num_segments] = seg_start;
      seg_raw[2 * num_segments + 1] = off;
      seg_stuffed[num_segments] = stuffed;
      ++num_segments;
      seg_start = off + 2;
      stuffed = 0;
    }
    p = ff + 2;
  }
}

}  // extern "C"
