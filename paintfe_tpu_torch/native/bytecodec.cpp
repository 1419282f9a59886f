// Byte-serial codec loops of paintfe_tpu_torch/io/deep_export.py: the port's
// own copy of paintfe_tpu/native/bytecodec.cpp (host code, built with g++ by
// paintfe_tpu_torch/native/__init__.py).
//
// Behavioral contracts:
//   * png_defilter — PNG spec §6 filter reconstruction (filters 0-4), the
//     import path for externally-produced 16-bit PNGs (io.rs:588-617 reads
//     them via the png crate).  The pure-Python png_defilter_plain in
//     deep_export.py is the oracle; this is the same byte math without the
//     interpreter.
//   * tiff_lzw_encode — TIFF6 LZW with the early-change width bump,
//     identical emission order to deep_export._lzw_encode_plain (the oracle).
//   * tiff_lzw_decode — its inverse, the bytes of deep_export._lzw_decode_plain
//     (the oracle) on every stream, garbage and truncated ones included: the
//     same early width bump, the same stop at max_bytes, a code past the
//     table's end read as prev + prev[0], and the same refusal of a code
//     past the fresh table right after a clear.  Strips of DNG/TIFF inputs
//     go through it.
//
// Both are inherently byte-serial (left-neighbor / dictionary dependency),
// which is why they run on the host and not on the card.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// raw: h rows of (1 filter byte + stride bytes).  out: h*stride bytes.
// Returns 0, or -1 on an unknown filter type.
int png_defilter(const uint8_t* raw, uint8_t* out,
                 uint32_t h, uint32_t stride, uint32_t bpp) {
    const uint8_t* prev = nullptr;
    for (uint32_t y = 0; y < h; ++y) {
        const uint8_t* src = raw + (uint64_t)y * (stride + 1);
        const uint8_t f = src[0];
        const uint8_t* line = src + 1;
        uint8_t* dst = out + (uint64_t)y * stride;
        switch (f) {
        case 0:
            memcpy(dst, line, stride);
            break;
        case 1:  // Sub
            for (uint32_t i = 0; i < stride; ++i)
                dst[i] = (uint8_t)(line[i] + (i >= bpp ? dst[i - bpp] : 0));
            break;
        case 2:  // Up
            for (uint32_t i = 0; i < stride; ++i)
                dst[i] = (uint8_t)(line[i] + (prev ? prev[i] : 0));
            break;
        case 3:  // Average
            for (uint32_t i = 0; i < stride; ++i) {
                const int a = i >= bpp ? dst[i - bpp] : 0;
                const int b = prev ? prev[i] : 0;
                dst[i] = (uint8_t)(line[i] + ((a + b) >> 1));
            }
            break;
        case 4:  // Paeth
            for (uint32_t i = 0; i < stride; ++i) {
                const int a = i >= bpp ? dst[i - bpp] : 0;
                const int b = prev ? prev[i] : 0;
                const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                const int pa = abs(b - c), pb = abs(a - c),
                          pc = abs(a + b - 2 * c);
                const int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                dst[i] = (uint8_t)(line[i] + pr);
            }
            break;
        default:
            return -1;
        }
        prev = dst;
    }
    return 0;
}

// TIFF6 LZW encode.  out must hold >= 2*n + 64 bytes.  Returns the number
// of bytes written, or -1 on overflow/allocation failure.
int64_t tiff_lzw_encode(const uint8_t* data, uint64_t n,
                        uint8_t* out, uint64_t cap) {
    enum { CLEAR = 256, EOI = 257, TABLE_BYTES = 4096 * 256 * 2 };
    uint16_t* table = (uint16_t*)malloc(TABLE_BYTES);
    if (!table) return -1;
    memset(table, 0xFF, TABLE_BYTES);  // 0xFFFF = empty slot

    uint64_t pos = 0;
    uint32_t bitbuf = 0;
    int bitcnt = 0, width = 9;
    bool overflow = false;
    auto emit = [&](int code) {
        bitbuf = (bitbuf << width) | (uint32_t)code;
        bitcnt += width;
        while (bitcnt >= 8) {
            bitcnt -= 8;
            if (pos >= cap) { overflow = true; return; }
            out[pos++] = (uint8_t)((bitbuf >> bitcnt) & 0xFF);
        }
    };

    int next_code = 258;
    emit(CLEAR);
    int w = -1;  // current prefix code (-1 = none)
    for (uint64_t k = 0; k < n && !overflow; ++k) {
        const uint8_t c = data[k];
        if (w < 0) { w = c; continue; }
        const uint32_t idx = ((uint32_t)w << 8) | c;
        const uint16_t e = table[idx];
        if (e != 0xFFFF) { w = e; continue; }
        emit(w);
        table[idx] = (uint16_t)next_code++;
        // TIFF early change: width bumps when next_code hits 2^width
        // (one entry ahead of the decoder; see _lzw_encode's comment).
        if (next_code == (1 << width)) {
            if (width < 12) {
                ++width;
            } else {
                emit(CLEAR);
                memset(table, 0xFF, TABLE_BYTES);
                next_code = 258;
                width = 9;
            }
        }
        w = c;
    }
    if (w >= 0) emit(w);
    emit(EOI);
    if (bitcnt && !overflow) {
        if (pos >= cap) overflow = true;
        else out[pos++] = (uint8_t)((bitbuf << (8 - bitcnt)) & 0xFF);
    }
    free(table);
    return overflow ? -1 : (int64_t)pos;
}

// TIFF6 LZW decode.  max_bytes < 0 decodes to the end of the stream (EOI or
// the last whole code); otherwise decoding stops once max_bytes bytes are
// out and the result is cut to max_bytes.  *out receives a malloc'd buffer
// (free it with pfe_free) and the return value is its length; -1 when a code
// follows a clear (or the start) that the fresh table does not hold, -2
// when memory runs out.  Entries are kept as (prefix code, first byte, last
// byte, length) chains; the table counts entries past 4096, which no 12-bit
// code can reach, as the oracle's list does.
int64_t tiff_lzw_decode(const uint8_t* data, uint64_t n, int64_t max_bytes,
                        uint8_t** out) {
    enum { CLEAR = 256, EOI = 257, SLOTS = 4096 };
    uint16_t prefix[SLOTS];
    uint8_t first[SLOTS], last[SLOTS];
    uint32_t length[SLOTS];
    for (int c = 0; c < 256; ++c) {
        prefix[c] = 0xFFFF;
        first[c] = last[c] = (uint8_t)c;
        length[c] = 1;
    }
    uint64_t cap = max_bytes >= 0 ? (uint64_t)max_bytes + SLOTS : 2 * n + SLOTS;
    uint8_t* buf = (uint8_t*)malloc(cap);
    if (!buf) return -2;
    uint64_t pos = 0, table_len = 258, i = 0;
    uint32_t bitbuf = 0;
    int bitcnt = 0, width = 9, prev = -1;
    while (max_bytes < 0 || pos < (uint64_t)max_bytes) {
        while (bitcnt < width && i < n) {
            bitbuf = (bitbuf << 8) | data[i++];
            bitcnt += 8;
        }
        if (bitcnt < width) break;
        bitcnt -= width;
        const int code = (int)((bitbuf >> bitcnt) & ((1u << width) - 1));
        bitbuf &= (1u << bitcnt) - 1;
        if (code == EOI) break;
        if (code == CLEAR) {
            table_len = 258;
            width = 9;
            prev = -1;
            continue;
        }
        int entry = code;
        if (prev < 0) {
            if ((uint64_t)code >= table_len) { free(buf); return -1; }
        } else {
            // the new entry: prev + the first byte of this code's string,
            // or of prev's own when the code is past the table's end
            const bool known = (uint64_t)code < table_len;
            if (table_len < SLOTS) {
                prefix[table_len] = (uint16_t)prev;
                first[table_len] = first[prev];
                last[table_len] = known ? first[code] : first[prev];
                length[table_len] = length[prev] + 1;
            }
            if (!known) entry = (int)table_len;  // table_len < SLOTS here
            ++table_len;
        }
        const uint32_t len = length[entry];
        if (pos + len > cap) {
            cap = 2 * cap + len;
            uint8_t* grown = (uint8_t*)realloc(buf, cap);
            if (!grown) { free(buf); return -2; }
            buf = grown;
        }
        int k = entry;
        for (uint32_t j = len; j-- > 0;) {
            buf[pos + j] = last[k];
            k = prefix[k];
        }
        pos += len;
        prev = entry;
        // decoder grows one slot early (TIFF early change)
        if (table_len == (1u << width) - 1 && width < 12) ++width;
    }
    if (max_bytes >= 0 && pos > (uint64_t)max_bytes) pos = (uint64_t)max_bytes;
    *out = buf;
    return (int64_t)pos;
}

void pfe_free(void* p) { free(p); }

}  // extern "C"
