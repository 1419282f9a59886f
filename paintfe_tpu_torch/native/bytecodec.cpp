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

}  // extern "C"
