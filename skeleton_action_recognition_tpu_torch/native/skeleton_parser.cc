// Fast NTU .skeleton text parser.
//
// The dataset has ~56k files parsed once per data_gen run; the reference's
// pure-Python line parser (gen_joint_data.py:22-62) is the hot loop of
// SURVEY §3.4. This scanner tokenizes the whole buffer in one pass,
// converting only the fields that are kept (the x/y/z of each joint line)
// with a hand-rolled decimal parser — the remaining 9 joint fields and the
// 10 body-info fields are skipped without conversion.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

namespace {

struct Scanner {
  const char* p;
  const char* end;

  inline bool skip_ws() {
    while (p < end && static_cast<unsigned char>(*p) <= ' ') ++p;
    return p < end;
  }

  inline bool skip_token() {
    if (!skip_ws()) return false;
    while (p < end && static_cast<unsigned char>(*p) > ' ') ++p;
    return true;
  }

  // Fast decimal parser: sign, integer, fraction, optional exponent.
  // Falls back to strtod for unusual tokens (inf/nan/hex).
  inline bool next_double(double* out) {
    if (!skip_ws()) return false;
    const char* start = p;
    bool neg = false;
    if (*p == '-') {
      neg = true;
      ++p;
    } else if (*p == '+') {
      ++p;
    }
    double value = 0.0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
      value = value * 10.0 + (*p - '0');
      ++p;
      any = true;
    }
    if (p < end && *p == '.') {
      ++p;
      double scale = 0.1;
      while (p < end && *p >= '0' && *p <= '9') {
        value += (*p - '0') * scale;
        scale *= 0.1;
        ++p;
        any = true;
      }
    }
    if (!any) {  // weird token (inf, nan, hex): strtod, else malformed
      char* q = nullptr;
      value = strtod(start, &q);
      if (q == start) return false;
      p = q;
      *out = value;
      return true;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p;
      bool eneg = false;
      if (p < end && (*p == '-' || *p == '+')) {
        eneg = (*p == '-');
        ++p;
      }
      long ex = 0;
      while (p < end && *p >= '0' && *p <= '9') {
        ex = ex * 10 + (*p - '0');
        ++p;
      }
      double factor = 1.0;
      double base = 10.0;
      while (ex) {
        if (ex & 1) factor *= base;
        base *= base;
        ex >>= 1;
      }
      value = eneg ? value / factor : value * factor;
    }
    *out = neg ? -value : value;
    return true;
  }

  inline bool next_long(long* out) {
    double v;
    if (!next_double(&v)) return false;
    *out = static_cast<long>(v);
    return true;
  }
};

}  // namespace

// Returns the number of frames stored (capped at max_frames), or a
// negative error code: -1 malformed header, -2 truncated data.
// `out` must be zero-initialized with room for
// max_body * max_frames * num_joint * 3 float32s.
extern "C" long sar_parse_skeleton(const char* text, size_t len,
                                   float* out, long max_body,
                                   long max_frames, long num_joint) {
  Scanner s{text, text + len};
  long num_frames;
  if (!s.next_long(&num_frames) || num_frames < 0) return -1;

  const long frame_stride = num_joint * 3;
  const long body_stride = max_frames * frame_stride;

  for (long t = 0; t < num_frames; ++t) {
    long num_body;
    if (!s.next_long(&num_body) || num_body < 0) return -2;
    for (long b = 0; b < num_body; ++b) {
      for (int k = 0; k < 10; ++k)  // body-info fields
        if (!s.skip_token()) return -2;
      long nj;
      if (!s.next_long(&nj) || nj < 0) return -2;
      const bool keep_body = b < max_body && t < max_frames;
      for (long j = 0; j < nj; ++j) {
        double x, y, z;
        if (!s.next_double(&x) || !s.next_double(&y) ||
            !s.next_double(&z))
          return -2;
        for (int k = 0; k < 9; ++k)  // remaining joint fields
          if (!s.skip_token()) return -2;
        if (keep_body && j < num_joint) {
          float* dst = out + b * body_stride + t * frame_stride + j * 3;
          dst[0] = static_cast<float>(x);
          dst[1] = static_cast<float>(y);
          dst[2] = static_cast<float>(z);
        }
      }
    }
  }
  return num_frames < max_frames ? num_frames : max_frames;
}
