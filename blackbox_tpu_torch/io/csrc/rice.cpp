// RICE_1 tile codec, CFITSIO-convention (fpack parity).
//
// The reference pipeline fpacks every product with content-dependent
// quantisation (reference blackbox.py:812-857, 8087-8108) through
// the CFITSIO fpack/funpack binaries.  This is the framework's native
// codec: Rice coding of zigzag-mapped first differences in 32-pixel
// blocks, with the CFITSIO block header conventions (fsbits/fsmax per
// byte width, low-entropy zero blocks, raw blocks at fs >= fsmax).
//
// Exposed as a C ABI for ctypes:
//   long rice_encode_i{1,2,4}(const T* in, long n, uint8* out, long cap)
//   long rice_decode_i{1,2,4}(const uint8* in, long nbytes, T* out, long n)
// return: bytes written / consumed, or -1 on overflow/corruption.

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

struct BitWriter {
    uint8_t* buf;
    long cap;
    long pos;       // byte position
    int bits;       // free bits remaining in current byte
    bool overflow;

    BitWriter(uint8_t* b, long c) : buf(b), cap(c), pos(0), bits(8),
                                    overflow(false) {
        if (cap > 0) buf[0] = 0;
    }
    // write the low `n` bits of v, MSB first (n <= 32)
    inline void put(uint32_t v, int n) {
        while (n > 0) {
            if (pos >= cap) { overflow = true; return; }
            int take = n < bits ? n : bits;
            uint32_t chunk = (v >> (n - take)) & ((1u << take) - 1u);
            buf[pos] |= (uint8_t)(chunk << (bits - take));
            bits -= take;
            n -= take;
            if (bits == 0) {
                ++pos;
                bits = 8;
                if (pos < cap) buf[pos] = 0;
            }
        }
    }
    // unary: `q` zero bits then a one bit
    inline void put_unary(uint32_t q) {
        while (q >= 24) { put(0, 24); q -= 24; }
        put(1u, (int)q + 1);
    }
    long flush() {
        if (overflow) return -1;
        return bits == 8 ? pos : pos + 1;
    }
};

struct BitReader {
    const uint8_t* buf;
    long nbytes;
    long pos;
    int bits;       // unread bits in current byte
    bool fail;

    BitReader(const uint8_t* b, long n) : buf(b), nbytes(n), pos(0),
                                          bits(8), fail(false) {}
    inline uint32_t get(int n) {
        uint32_t v = 0;
        while (n > 0) {
            if (pos >= nbytes) { fail = true; return 0; }
            int take = n < bits ? n : bits;
            uint32_t chunk = (buf[pos] >> (bits - take))
                & ((1u << take) - 1u);
            v = (v << take) | chunk;
            bits -= take;
            n -= take;
            if (bits == 0) { ++pos; bits = 8; }
        }
        return v;
    }
    inline uint32_t get_unary() {
        uint32_t q = 0;
        for (;;) {
            if (pos >= nbytes) { fail = true; return 0; }
            if (get(1)) return q;
            ++q;
            if (q > (1u << 28)) { fail = true; return 0; }
        }
    }
    long consumed() const { return bits == 8 ? pos : pos + 1; }
};

constexpr int NBLOCK = 32;

template <typename T, int FSBITS, int FSMAX, int BBITS>
long encode(const T* in, long n, uint8_t* out, long cap) {
    // All difference arithmetic is modular in the type's width (CFITSIO
    // convention): diffs of w-bit ints span w+1 bits, but mod-2^w
    // wraparound keeps the zigzag mapping bijective.
    using U = typename std::make_unsigned<T>::type;
    if (n <= 0) return 0;
    BitWriter w(out, cap);
    // first pixel raw
    w.put((uint32_t)(U)in[0], BBITS);
    U last = (U)in[0];
    uint32_t diff[NBLOCK];
    for (long start = 1; start < n; start += NBLOCK) {
        int m = (int)((n - start) < NBLOCK ? (n - start) : NBLOCK);
        uint64_t sum = 0;
        for (int j = 0; j < m; ++j) {
            U d = (U)((U)in[start + j] - last);       // mod 2^w
            last = (U)in[start + j];
            bool neg = (d >> (BBITS - 1)) & 1u;       // top bit = "negative"
            U u = neg ? (U)~(U)(d << 1) : (U)(d << 1);
            diff[j] = (uint32_t)u;
            sum += diff[j];
        }
        // Rice parameter: 2^fs ~ mean(diff)
        int fs = 0;
        uint64_t psum = (sum >> 1);
        if (sum > 0) {
            psum = (sum - (uint64_t)m / 2 - 1) / (uint64_t)m;
            while (psum > 0) { psum >>= 1; ++fs; }
        } else {
            fs = -1;
        }
        if (fs < 0) {
            w.put(0, FSBITS);                       // all-zero block
        } else if (fs >= FSMAX) {
            w.put((uint32_t)(FSMAX + 1), FSBITS);   // raw block
            for (int j = 0; j < m; ++j) w.put(diff[j], BBITS);
        } else {
            w.put((uint32_t)(fs + 1), FSBITS);
            for (int j = 0; j < m; ++j) {
                w.put_unary(diff[j] >> fs);
                if (fs > 0) w.put(diff[j] & ((1u << fs) - 1u), fs);
            }
        }
        if (w.overflow) return -1;
    }
    return w.flush();
}

template <typename T, int FSBITS, int FSMAX, int BBITS>
long decode(const uint8_t* in, long nbytes, T* out, long n) {
    using U = typename std::make_unsigned<T>::type;
    if (n <= 0) return 0;
    BitReader r(in, nbytes);
    U last = (U)r.get(BBITS);
    out[0] = (T)last;
    auto unmap = [&](uint32_t u32) {
        U u = (U)u32;
        U d = (u & 1u) ? (U)~(U)(u >> 1) : (U)(u >> 1);
        last = (U)(last + d);                          // mod 2^w
        return (T)last;
    };
    for (long start = 1; start < n; start += NBLOCK) {
        int m = (int)((n - start) < NBLOCK ? (n - start) : NBLOCK);
        uint32_t code = r.get(FSBITS);
        if (r.fail) return -1;
        if (code == 0) {
            for (int j = 0; j < m; ++j) out[start + j] = (T)last;
        } else if (code == (uint32_t)(FSMAX + 1)) {
            for (int j = 0; j < m; ++j)
                out[start + j] = unmap(r.get(BBITS));
        } else {
            int fs = (int)code - 1;
            for (int j = 0; j < m; ++j) {
                uint32_t q = r.get_unary();
                uint32_t u = (q << fs) | (fs > 0 ? r.get(fs) : 0u);
                out[start + j] = unmap(u);
            }
        }
        if (r.fail) return -1;
    }
    return r.consumed();
}

}  // namespace

extern "C" {

long rice_encode_i4(const int32_t* in, long n, uint8_t* out, long cap) {
    return encode<int32_t, 5, 25, 32>(in, n, out, cap);
}
long rice_decode_i4(const uint8_t* in, long nb, int32_t* out, long n) {
    return decode<int32_t, 5, 25, 32>(in, nb, out, n);
}
long rice_encode_i2(const int16_t* in, long n, uint8_t* out, long cap) {
    return encode<int16_t, 4, 14, 16>(in, n, out, cap);
}
long rice_decode_i2(const uint8_t* in, long nb, int16_t* out, long n) {
    return decode<int16_t, 4, 14, 16>(in, nb, out, n);
}
long rice_encode_i1(const uint8_t* in, long n, uint8_t* out, long cap) {
    return encode<uint8_t, 3, 6, 8>(in, n, out, cap);
}
long rice_decode_i1(const uint8_t* in, long nb, uint8_t* out, long n) {
    return decode<uint8_t, 3, 6, 8>(in, nb, out, n);
}

}  // extern "C"
