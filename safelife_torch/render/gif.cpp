// GIF encoding on the host (used by render/graphics.py through ctypes):
// RGB pixels to the indices of a global palette, and one frame's LZW code
// stream as GIF89a codes it (variable-width codes of min_bits + 1 to 12
// bits, packed least significant bit first, a clear code when the table
// is full).  Built with g++ on first use; a plain C interface.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxCode = 4096;
constexpr int kTableSize = 8192;  // open addressing, at most 3838 entries

struct BitWriter {
    uint8_t* out;
    long long cap, pos = 0;
    uint32_t acc = 0;
    int bits = 0;

    bool put(int code, int width) {
        acc |= uint32_t(code) << bits;
        bits += width;
        while (bits >= 8) {
            if (pos >= cap) return false;
            out[pos++] = uint8_t(acc);
            acc >>= 8;
            bits -= 8;
        }
        return true;
    }

    bool flush() {
        if (bits > 0) {
            if (pos >= cap) return false;
            out[pos++] = uint8_t(acc);
            acc = 0;
            bits = 0;
        }
        return true;
    }
};

inline uint32_t slot_of(uint32_t key) {
    return (key * 2654435761u) >> (32 - 13);
}

}  // namespace

extern "C" {

// Map n RGB pixels to indices of an append-only palette of at most 256
// colours (palette: 256 x 3 bytes of which `size` are in use; new colours
// are appended).  Returns the new size, or -1 when a 257th colour appears.
int sl_gif_index(const uint8_t* rgb, long long n, uint8_t* palette, int size,
                 uint8_t* out) {
    int32_t keys[1024];
    uint8_t vals[1024];
    std::memset(keys, 0xff, sizeof(keys));
    auto find = [&](uint32_t key) {
        uint32_t s = (key * 2654435761u) >> 22;
        while (keys[s] >= 0 && uint32_t(keys[s]) != key) s = (s + 1) & 1023;
        return s;
    };
    for (int i = 0; i < size; ++i) {
        uint32_t key = palette[3 * i] << 16 | palette[3 * i + 1] << 8 |
                       palette[3 * i + 2];
        uint32_t s = find(key);
        keys[s] = int32_t(key);
        vals[s] = uint8_t(i);
    }
    uint32_t last_key = 0xffffffffu;
    uint8_t last = 0;
    for (long long p = 0; p < n; ++p) {
        uint32_t key = rgb[3 * p] << 16 | rgb[3 * p + 1] << 8 | rgb[3 * p + 2];
        if (key != last_key) {
            uint32_t s = find(key);
            if (keys[s] < 0) {
                if (size == 256) return -1;
                keys[s] = int32_t(key);
                vals[s] = uint8_t(size);
                std::memcpy(palette + 3 * size, rgb + 3 * p, 3);
                ++size;
            }
            last_key = key;
            last = vals[s];
        }
        out[p] = last;
    }
    return size;
}

// The LZW code stream of n palette indices (each below 1 << min_bits),
// from the first clear code to the end code, into out (cap bytes).
// Returns the bytes written, or -1 when cap is too small.
long long sl_gif_lzw(const uint8_t* idx, long long n, int min_bits,
                     uint8_t* out, long long cap) {
    static thread_local int32_t keys[kTableSize];
    static thread_local uint16_t codes[kTableSize];
    const int clear = 1 << min_bits, end = clear + 1;
    int width = min_bits + 1, next = clear + 2;
    BitWriter bw{out, cap};
    std::memset(keys, 0xff, sizeof(keys));
    if (!bw.put(clear, width)) return -1;
    if (n > 0) {
        int prefix = idx[0];
        for (long long i = 1; i < n; ++i) {
            const int k = idx[i];
            const uint32_t key = uint32_t(prefix) << 8 | uint32_t(k);
            uint32_t s = slot_of(key);
            while (keys[s] >= 0 && uint32_t(keys[s]) != key)
                s = (s + 1) & (kTableSize - 1);
            if (keys[s] >= 0) {
                prefix = codes[s];
                continue;
            }
            if (!bw.put(prefix, width)) return -1;
            // A decoder adds its entry one code later than the encoder, so
            // it widens its codes when the table, before this code's entry,
            // reaches 1 << width.
            if (next == (1 << width) && width < 12) ++width;
            if (next < kMaxCode) {
                keys[s] = int32_t(key);
                codes[s] = uint16_t(next++);
            } else {
                if (!bw.put(clear, width)) return -1;
                std::memset(keys, 0xff, sizeof(keys));
                width = min_bits + 1;
                next = clear + 2;
            }
            prefix = k;
        }
        if (!bw.put(prefix, width)) return -1;
        if (next == (1 << width) && width < 12) ++width;
    }
    if (!bw.put(end, width) || !bw.flush()) return -1;
    return bw.pos;
}

}  // extern "C"
