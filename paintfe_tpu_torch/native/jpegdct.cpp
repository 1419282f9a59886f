// Baseline sequential DCT JPEG (ITU-T T.81 process 1, SOF0/SOF1) decoder.
//
// Behavioral contract: the reference opens lossy-compressed DNGs
// (Compression=34892, 8-bit baseline JPEG per the public DNG 1.4 spec)
// through the rawloader crate (the reference's src/io.rs:36-80).  This is
// an original from-spec implementation: marker parse -> Huffman entropy
// decode (DC diff + AC run/size with EOB/ZRL) -> dequantize -> de-zigzag
// -> separable double-precision 8x8 IDCT -> level shift.  Components are
// returned RAW (no YCbCr->RGB): DNG LinearRaw semantics; callers apply a
// color transform only when the stream is known to carry one.
//
// Scope: 8-bit precision, 1-4 components, H=V=1 sampling (Adobe's lossy
// DNG writer does not subsample), single interleaved scan, restart
// intervals.  Progressive / arithmetic / 12-bit / subsampled streams
// return -2 (unsupported) with no partial output.
//
// Exposed C ABI:
//   jpegdct_info(data, len, info[3])   -> 0 / error; info = {X, Y, Nf}
//   jpegdct_decode(data, len, out, cap) -> 0 / error; out row-major,
//       interleaved by component, Y rows of X*Nf uint8 samples.
// Errors: -1 malformed stream, -2 unsupported feature, -3 truncated
// entropy data, -4 output capacity too small.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace jpegdct {

struct Huff {
    int32_t nvals = 0;
    uint8_t vals[256];
    int32_t mincode[17];
    int32_t maxcode[17];
    int32_t valptr[17];
    bool present = false;

    void build(const uint8_t bits[17]) {
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            if (bits[l]) {
                code += bits[l];
                k += bits[l];
                maxcode[l] = code - 1;
            } else {
                maxcode[l] = -1;
            }
            code <<= 1;
        }
        nvals = k;
        present = true;
    }
};

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint32_t cur = 0;
    int nbits = 0;
    bool fabricated = false;
    bool at_marker = false;

    BitReader(const uint8_t* start, const uint8_t* stop) : p(start), end(stop) {}

    int next_byte() {
        if (at_marker || p >= end) {
            fabricated = true;
            return 0;
        }
        uint8_t b = *p++;
        if (b == 0xFF) {
            if (p >= end) {
                fabricated = true;
                return 0xFF;
            }
            if (*p == 0x00) {
                p++;  // stuffed literal 0xFF
                return 0xFF;
            }
            p--;  // leave the marker for read_restart / EOI detection
            at_marker = true;
            fabricated = true;
            return 0;
        }
        return b;
    }

    int get_bit() {
        if (nbits == 0) {
            cur = (uint32_t)next_byte();
            nbits = 8;
        }
        nbits--;
        return (cur >> nbits) & 1;
    }

    int get_bits(int n) {
        int v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | get_bit();
        return v;
    }

    int read_restart() {
        nbits = 0;
        fabricated = false;
        at_marker = false;
        if (p + 2 > end) return -1;
        if (p[0] != 0xFF) return -1;
        uint8_t m = p[1];
        if (m < 0xD0 || m > 0xD7) return -1;
        p += 2;
        return m - 0xD0;
    }
};

inline int decode_huff(const Huff& h, BitReader& br) {
    int code = br.get_bit();
    int l = 1;
    while (l <= 16 && code > h.maxcode[l]) {
        code = (code << 1) | br.get_bit();
        l++;
    }
    if (l > 16) return -1;
    int idx = h.valptr[l] + code - h.mincode[l];
    if (idx < 0 || idx >= h.nvals) return -1;
    return h.vals[idx];
}

// T.81 F.2.2.1 EXTEND
inline int extend(int v, int ssss) {
    return (v < (1 << (ssss - 1))) ? v - (1 << ssss) + 1 : v;
}

// T.81 Figure A.6 zigzag: index-in-scan -> natural (row*8+col) position
static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Frame {
    int height = 0;
    int width = 0;
    int ncomp = 0;
    int comp_id[4];
    int comp_qt[4];
    int comp_dc[4] = {-1, -1, -1, -1};
    int comp_ac[4] = {-1, -1, -1, -1};
    int restart_interval = 0;
    const uint8_t* entropy = nullptr;
};

inline int rd16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Parse markers through SOS; fills frame, Huffman and quant tables.
int parse_headers(const uint8_t* data, uint32_t len, Frame& fr,
                  Huff dc_tab[4], Huff ac_tab[4], uint16_t qt[4][64],
                  bool qt_present[4]) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // SOI
    uint32_t pos = 2;
    bool have_sof = false;
    while (pos + 4 <= len) {
        if (data[pos] != 0xFF) return -1;
        while (pos < len && data[pos] == 0xFF) pos++;  // fill bytes
        if (pos >= len) return -1;
        uint8_t m = data[pos++];
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
        if (pos + 2 > len) return -1;
        uint32_t seglen = rd16(data + pos);
        if (seglen < 2 || pos + seglen > len) return -1;
        const uint8_t* seg = data + pos + 2;
        uint32_t segbytes = seglen - 2;
        if (m == 0xC0 || m == 0xC1) {  // SOF0 baseline / SOF1 ext. seq.
            if (segbytes < 6) return -1;
            int precision = seg[0];
            fr.height = rd16(seg + 1);
            fr.width = rd16(seg + 3);
            fr.ncomp = seg[5];
            if (precision != 8) return -2;  // 12-bit ext. seq. unsupported
            if (fr.ncomp < 1 || fr.ncomp > 4) return -2;
            if (segbytes < 6u + 3u * fr.ncomp) return -1;
            for (int c = 0; c < fr.ncomp; c++) {
                fr.comp_id[c] = seg[6 + 3 * c];
                if (seg[7 + 3 * c] != 0x11) return -2;  // H=V=1 only
                fr.comp_qt[c] = seg[8 + 3 * c];
                if (fr.comp_qt[c] > 3) return -1;
            }
            have_sof = true;
        } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                   m != 0xCC) {
            return -2;  // progressive / lossless / arithmetic SOF
        } else if (m == 0xC4) {  // DHT
            uint32_t o = 0;
            while (o + 17 <= segbytes) {
                int tc = (seg[o] >> 4) & 0x0F;
                int th = seg[o] & 0x0F;
                if (tc > 1 || th > 3) return -1;
                uint8_t bits[17] = {0};
                int total = 0;
                for (int l = 1; l <= 16; l++) {
                    bits[l] = seg[o + l];
                    total += bits[l];
                }
                if (total > 256 || o + 17 + total > segbytes) return -1;
                Huff& t = tc == 0 ? dc_tab[th] : ac_tab[th];
                for (int i = 0; i < total; i++) t.vals[i] = seg[o + 17 + i];
                t.build(bits);
                o += 17 + total;
            }
        } else if (m == 0xDB) {  // DQT: 8- or 16-bit entries, zigzag order
            uint32_t o = 0;
            while (o < segbytes) {
                int pq = (seg[o] >> 4) & 0x0F;
                int tq = seg[o] & 0x0F;
                if (pq > 1 || tq > 3) return -1;
                uint32_t need = 1 + 64 * (pq + 1);
                if (o + need > segbytes) return -1;
                for (int i = 0; i < 64; i++)
                    qt[tq][i] = pq ? rd16(seg + o + 1 + 2 * i)
                                   : seg[o + 1 + i];
                qt_present[tq] = true;
                o += need;
            }
        } else if (m == 0xDD) {  // DRI
            if (segbytes < 2) return -1;
            fr.restart_interval = rd16(seg);
        } else if (m == 0xDA) {  // SOS
            if (!have_sof) return -1;
            if (segbytes < 1) return -1;
            int ns = seg[0];
            if (ns != fr.ncomp) return -2;  // single interleaved scan only
            if (segbytes < 1u + 2u * ns + 3u) return -1;
            for (int s = 0; s < ns; s++) {
                int cs = seg[1 + 2 * s];
                int td = (seg[2 + 2 * s] >> 4) & 0x0F;
                int ta = seg[2 + 2 * s] & 0x0F;
                if (td > 3 || ta > 3) return -1;
                int found = -1;
                for (int c = 0; c < fr.ncomp; c++)
                    if (fr.comp_id[c] == cs) found = c;
                if (found < 0) return -1;
                fr.comp_dc[found] = td;
                fr.comp_ac[found] = ta;
            }
            for (int c = 0; c < fr.ncomp; c++)
                if (fr.comp_dc[c] < 0 || fr.comp_ac[c] < 0) return -1;
            // baseline spectral selection must span the full block
            if (seg[1 + 2 * ns] != 0 || seg[2 + 2 * ns] != 63) return -2;
            if (seg[3 + 2 * ns] != 0) return -2;  // Ah/Al successive approx
            fr.entropy = data + pos + seglen;
            return 0;
        } else if (m == 0xD9) {
            return -1;  // EOI before any scan
        }
        pos += seglen;  // APPn / COM / anything else: skip
    }
    return -1;
}

// Separable exact IDCT (double precision): accuracy well inside the T.81
// Annex A compliance bound, so output differs from any compliant decoder
// (libjpeg islow included) by at most 1 per sample.
struct IdctTables {
    double cs[8][8];  // cs[x][u] = C(u)/2 * cos((2x+1) u pi / 16)

    IdctTables() {
        for (int x = 0; x < 8; x++)
            for (int u = 0; u < 8; u++) {
                double cu = u == 0 ? 1.0 / std::sqrt(2.0) : 1.0;
                cs[x][u] = 0.5 * cu * std::cos((2 * x + 1) * u * M_PI / 16.0);
            }
    }
};

void idct8x8(const int32_t block[64], const IdctTables& t, uint8_t out[64]) {
    double tmp[64];
    for (int y = 0; y < 8; y++)        // 1-D IDCT along rows (u axis)
        for (int x = 0; x < 8; x++) {
            double s = 0.0;
            for (int u = 0; u < 8; u++) s += t.cs[x][u] * block[y * 8 + u];
            tmp[y * 8 + x] = s;
        }
    for (int x = 0; x < 8; x++)        // then along columns (v axis)
        for (int y = 0; y < 8; y++) {
            double s = 0.0;
            for (int v = 0; v < 8; v++) s += t.cs[y][v] * tmp[v * 8 + x];
            long r = std::lround(s) + 128;
            out[y * 8 + x] = r < 0 ? 0 : (r > 255 ? 255 : (uint8_t)r);
        }
}

}  // namespace jpegdct

extern "C" {

int jpegdct_info(const uint8_t* data, uint32_t len, uint32_t info[3]) {
    using namespace jpegdct;
    Frame fr;
    Huff dc_tab[4], ac_tab[4];
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    int rc = parse_headers(data, len, fr, dc_tab, ac_tab, qt, qt_present);
    if (rc != 0) return rc;
    info[0] = (uint32_t)fr.width;
    info[1] = (uint32_t)fr.height;
    info[2] = (uint32_t)fr.ncomp;
    return 0;
}

int jpegdct_decode(const uint8_t* data, uint32_t len, uint8_t* out,
                   uint64_t cap) {
    using namespace jpegdct;
    Frame fr;
    Huff dc_tab[4], ac_tab[4];
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    int rc = parse_headers(data, len, fr, dc_tab, ac_tab, qt, qt_present);
    if (rc != 0) return rc;
    const int W = fr.width, H = fr.height, NC = fr.ncomp;
    const uint64_t total = (uint64_t)W * H * NC;
    if (total == 0) return -1;
    if (cap < total) return -4;
    for (int c = 0; c < NC; c++) {
        if (!dc_tab[fr.comp_dc[c]].present) return -1;
        if (!ac_tab[fr.comp_ac[c]].present) return -1;
        if (!qt_present[fr.comp_qt[c]]) return -1;
    }

    static const IdctTables tables;  // cos table is immutable, share it
    BitReader br(fr.entropy, data + len);
    const int bx = (W + 7) / 8, by = (H + 7) / 8;
    int dc_pred[4] = {0, 0, 0, 0};
    int mcus_until_restart = fr.restart_interval;
    int next_rst = 0;

    int32_t block[64];
    uint8_t pix[64];
    for (int myc = 0; myc < by; myc++) {
        for (int mxc = 0; mxc < bx; mxc++) {
            if (fr.restart_interval && mcus_until_restart == 0) {
                int idx = br.read_restart();
                if (idx < 0 || idx != next_rst) return -3;
                next_rst = (next_rst + 1) & 7;
                mcus_until_restart = fr.restart_interval;
                dc_pred[0] = dc_pred[1] = dc_pred[2] = dc_pred[3] = 0;
            }
            for (int c = 0; c < NC; c++) {
                const uint16_t* q = qt[fr.comp_qt[c]];
                std::memset(block, 0, sizeof(block));
                int ssss = decode_huff(dc_tab[fr.comp_dc[c]], br);
                if (ssss < 0 || ssss > 11) return -3;
                int diff = ssss ? extend(br.get_bits(ssss), ssss) : 0;
                if (br.fabricated) return -3;
                dc_pred[c] += diff;
                block[0] = dc_pred[c] * (int32_t)q[0];
                for (int k = 1; k < 64;) {
                    int rs = decode_huff(ac_tab[fr.comp_ac[c]], br);
                    if (rs < 0) return -3;
                    int r = rs >> 4, s = rs & 15;
                    if (s == 0) {
                        if (r != 15) break;  // EOB
                        k += 16;             // ZRL
                        continue;
                    }
                    k += r;
                    if (k > 63) return -1;
                    int v = extend(br.get_bits(s), s);
                    if (br.fabricated) return -3;
                    block[kZigzag[k]] = v * (int32_t)q[k];
                    k++;
                }
                idct8x8(block, tables, pix);
                // place the 8x8 block, clipping the image boundary
                const int x0 = mxc * 8, y0 = myc * 8;
                const int rows = y0 + 8 <= H ? 8 : H - y0;
                const int cols = x0 + 8 <= W ? 8 : W - x0;
                for (int yy = 0; yy < rows; yy++) {
                    uint8_t* dst = out + ((uint64_t)(y0 + yy) * W + x0) * NC + c;
                    for (int xx = 0; xx < cols; xx++)
                        dst[xx * NC] = pix[yy * 8 + xx];
                }
            }
            if (fr.restart_interval) mcus_until_restart--;
        }
    }
    return 0;
}

}  // extern "C"
