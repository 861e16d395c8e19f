// Native postings codec: delta + varint encoding of posting tiles.
//
// Reference analog: Lucene's ForUtil/PForUtil block codecs decoded by
// Lucene912PostingsReader — the native-speed inner loop of on-disk
// postings (SURVEY.md §2.5 "Lucene postings block decode" row). The
// TPU-native framework stores postings as dense [n_tiles, 128] int32
// arrays for HBM upload; this codec is the on-DISK form under
// index.codec=best_compression: doc ids are sorted per term, so
// delta+varint shrinks them ~4x, and the one-time decode at index load
// runs here in C++ (a Python fallback exists for toolchain-less hosts).
//
// Layout: per value, LEB128 varint. Doc-id streams are delta-encoded
// per tile row (first value absolute, INVALID_DOC sentinel -1 encoded
// as zigzag). tf streams are raw varints.
//
// Build: g++ -O3 -shared -fPIC postings_codec.cpp -o libpostings.so
// (driven by elasticsearch_tpu/native/__init__.py via ctypes).

#include <cstdint>
#include <cstddef>

extern "C" {

// zigzag so the -1 padding sentinel stays one byte
static inline uint32_t zz_enc(int32_t v) {
    return ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
}
static inline int32_t zz_dec(uint32_t v) {
    return (int32_t)((v >> 1) ^ (~(v & 1) + 1));
}

// Encodes n int32 values as zigzag varints into out (caller sizes out
// at n*5). Returns bytes written.
int64_t vb_encode(const int32_t* vals, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        uint32_t v = zz_enc(vals[i]);
        while (v >= 0x80) {
            *p++ = (uint8_t)(v | 0x80);
            v >>= 7;
        }
        *p++ = (uint8_t)v;
    }
    return (int64_t)(p - out);
}

// Decodes exactly n values; returns bytes consumed, or -1 if the
// stream ends early (corrupt input never reads past `len`).
int64_t vb_decode(const uint8_t* in, int64_t len, int32_t* out, int64_t n) {
    const uint8_t* p = in;
    const uint8_t* end = in + len;
    for (int64_t i = 0; i < n; i++) {
        uint32_t v = 0;
        int shift = 0;
        for (;;) {
            if (p >= end || shift > 28) return -1;
            uint8_t b = *p++;
            v |= (uint32_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        out[i] = zz_dec(v);
    }
    return (int64_t)(p - in);
}

// Delta-encodes doc-id tile rows ([n_tiles, width] int32, -1 padding):
// within each row, the first real value is absolute and subsequent real
// values are deltas (sorted ascending per term run, so deltas are
// small); -1 padding encodes as 0 after an end-of-row marker scheme:
// padding is encoded as the value -1 delta'd against itself (delta 0
// would collide), so we simply switch to absolute -1, which zigzags to
// one byte.
//
// Rows MUST be ascending: a negative delta would alias the -1 padding
// sentinel and round-trip silently corrupted, so an unsorted row
// returns -1 (the Python wrapper raises).
int64_t tiles_encode(const int32_t* vals, int64_t n_tiles, int64_t width,
                     uint8_t* out) {
    uint8_t* p = out;
    for (int64_t t = 0; t < n_tiles; t++) {
        const int32_t* row = vals + t * width;
        int32_t prev = 0;
        int first = 1;
        for (int64_t i = 0; i < width; i++) {
            int32_t v = row[i];
            int32_t enc;
            if (v < 0) {
                enc = -1;  // padding: absolute, one byte
            } else if (first) {
                enc = v;
                prev = v;
                first = 0;
            } else {
                if (v < prev) return -1;  // unsorted row: refuse
                enc = v - prev;
                prev = v;
            }
            uint32_t u = zz_enc(enc);
            while (u >= 0x80) {
                *p++ = (uint8_t)(u | 0x80);
                u >>= 7;
            }
            *p++ = (uint8_t)u;
        }
    }
    return (int64_t)(p - out);
}

int64_t tiles_decode(const uint8_t* in, int64_t len, int32_t* out,
                     int64_t n_tiles, int64_t width) {
    const uint8_t* p = in;
    const uint8_t* end = in + len;
    for (int64_t t = 0; t < n_tiles; t++) {
        int32_t* row = out + t * width;
        int32_t prev = 0;
        int first = 1;
        for (int64_t i = 0; i < width; i++) {
            uint32_t u = 0;
            int shift = 0;
            for (;;) {
                if (p >= end || shift > 28) return -1;
                uint8_t b = *p++;
                u |= (uint32_t)(b & 0x7F) << shift;
                if (!(b & 0x80)) break;
                shift += 7;
            }
            int32_t v = zz_dec(u);
            if (v == -1) {
                row[i] = -1;  // padding sentinel: first/prev untouched
            } else if (first) {
                row[i] = v;
                prev = v;
                first = 0;
            } else {
                prev += v;
                row[i] = prev;
            }
        }
    }
    return (int64_t)(p - in);
}

}  // extern "C"
