// Host CRC32-Castagnoli for the needle checksum (util/crc.py), for hosts
// without the google-crc32c package. No device code: nvcc hands the whole
// file to the host compiler, and the library loads through ctypes like the
// kernels' libraries do.
//
//   crc32c_extend(crc, p, n) = CRC32C of p[0, n) continued from crc
//
// the same function as google_crc32c.extend and util/crc.py's table loop
// (reflected polynomial 0x82F63B78, register inverted on entry and exit).
// Slicing-by-8: eight 256-entry tables fold eight bytes a step, so a
// 1 KiB needle takes about 128 steps instead of the table loop's 1,024
// Python iterations.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "host_crc32c.cu folds 8-byte little-endian words"
#endif

namespace {

struct Tables {
    uint32_t t[8][256];
    Tables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
            t[0][i] = c;
        }
        for (int k = 1; k < 8; ++k)
            for (uint32_t i = 0; i < 256; ++i)
                t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
    }
};

const Tables kTables;

}  // namespace

extern "C" uint32_t crc32c_extend(uint32_t crc, const unsigned char* p, size_t n) {
    const auto& t = kTables.t;
    uint32_t c = ~crc;
    for (; n && (reinterpret_cast<uintptr_t>(p) & 7); --n) c = t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    for (; n >= 8; n -= 8, p += 8) {
        uint64_t w;
        std::memcpy(&w, p, 8);
        w ^= c;
        c = t[7][w & 0xFF] ^ t[6][(w >> 8) & 0xFF] ^ t[5][(w >> 16) & 0xFF] ^ t[4][(w >> 24) & 0xFF]
            ^ t[3][(w >> 32) & 0xFF] ^ t[2][(w >> 40) & 0xFF] ^ t[1][(w >> 48) & 0xFF]
            ^ t[0][w >> 56];
    }
    for (; n; --n) c = t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return ~c;
}
