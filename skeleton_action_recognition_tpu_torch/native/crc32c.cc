// crc32c (Castagnoli) — slice-by-8 software implementation with an SSE4.2
// hardware fast path when available.
//
// This is the hot loop of the TFRecord container (framing checksums both
// sides of every record) and of the TensorBoard event writer, which share
// the format. The pure-Python fallback in data/tfrecord.py processes
// ~1 MB/s; this does GB/s.

#include <cstddef>
#include <cstdint>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// The slice-by-8 tables, built once on first use; a function-local static
// is initialized exactly once even when several threads decode shards at
// the same moment.
struct Tables {
  uint32_t t[8][256];
  Tables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables& tables() {
  static const Tables instance;
  return instance;
}

}  // namespace

extern "C" uint32_t sar_crc32c(const unsigned char* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  while (n >= 8) {
    uint64_t chunk;
    __builtin_memcpy(&chunk, data, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, chunk));
    data += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *data++);
#else
  const auto& table = tables().t;
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    __builtin_memcpy(&lo, data, 4);
    __builtin_memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
          table[5][(lo >> 16) & 0xFF] ^ table[4][lo >> 24] ^
          table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
          table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
#endif
  return crc ^ 0xFFFFFFFFu;
}
