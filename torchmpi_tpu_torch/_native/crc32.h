// Shared CRC32 (IEEE 802.3, poly 0xEDB88320) for the host planes' frame
// integrity trailers — ONE definition for hostcomm.cpp and ps.cpp, like
// bf16.h for the wire dtypes.  Self-contained (no zlib link dependency:
// the build is a bare g++ -shared, build.py:47-55).
//
// Incremental form: seed with kCrc32Init, fold chunks with crc32Update as
// they land (the chunked ring receives reduce sub-pieces as they arrive),
// finalize with crc32Final.  One-shot crc32Of for whole buffers.
#pragma once

#include <array>
#include <cstddef>
#include <cstdint>

inline const uint32_t* crc32Table() {
  // Magic-static: C++11 guarantees one thread-safe initialization even
  // when ring worker threads race the first frame.
  static const std::array<uint32_t, 256> table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
      t[i] = c;
    }
    return t;
  }();
  return table.data();
}

constexpr uint32_t kCrc32Init = 0xFFFFFFFFu;

inline uint32_t crc32Update(uint32_t crc, const void* buf, size_t n) {
  const uint32_t* table = crc32Table();
  const unsigned char* p = static_cast<const unsigned char*>(buf);
  for (size_t i = 0; i < n; ++i)
    crc = table[(crc ^ p[i]) & 0xFFu] ^ (crc >> 8);
  return crc;
}

inline uint32_t crc32Final(uint32_t crc) { return crc ^ 0xFFFFFFFFu; }

inline uint32_t crc32Of(const void* buf, size_t n) {
  return crc32Final(crc32Update(kCrc32Init, buf, n));
}
