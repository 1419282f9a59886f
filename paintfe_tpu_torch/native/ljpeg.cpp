// Lossless JPEG (ITU-T T.81 process 14, SOF3) decoder.
//
// Behavioral contract: the reference opens lossless-JPEG-compressed RAW
// containers (DNG Compression=7 strips/tiles, Canon CR2) through the
// rawloader crate (the reference's src/io.rs:36-80).  This is an original
// from-spec implementation: marker parse -> Huffman-coded difference
// entropy decode -> integer predictor reconstruction (predictors 1-7,
// point transform, restart intervals with per-interval 1-D reprediction,
// 0xFF00 byte unstuffing).
//
// Scope: 2-16 bit precision, 1-4 components, H=V=1 sampling (every RAW
// LJPEG in the wild except Canon sRAW), single interleaved scan.
//
// Exposed C ABI:
//   ljpeg_info(data, len, info[4])  -> 0 / error; info = {X, Y, Nf, P}
//   ljpeg_decode(data, len, out, cap) -> 0 / error; out row-major,
//       interleaved by component, Y rows of X*Nf uint16 samples.
// Errors: -1 malformed stream, -2 unsupported feature, -3 truncated
// entropy data, -4 output capacity too small.

#include <cstdint>
#include <cstring>

namespace {

struct Huff {
    int32_t nvals = 0;  // up to 256 symbols: must not be truncated to u8
    uint8_t vals[256];
    int32_t mincode[17];
    int32_t maxcode[17];  // -1 where no codes of that length
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
    bool fabricated = false;  // fed zero bits past end / at a marker
    bool at_marker = false;   // next bytes are 0xFF <non-stuffing marker>

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
            p--;  // leave 0xFF in place; caller may consume the marker
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

    // Align to a byte boundary and consume an expected RSTn marker.
    // Returns the marker low nibble (0-7) or -1.
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

// T.81 F.2.2.1 EXTEND: map magnitude-category bits to a signed difference.
inline int extend(int v, int ssss) {
    return (v < (1 << (ssss - 1))) ? v - (1 << ssss) + 1 : v;
}

struct Frame {
    int precision = 0;
    int height = 0;
    int width = 0;  // samples per line, per component
    int ncomp = 0;
    int comp_id[4];
    int comp_table[4] = {-1, -1, -1, -1};  // DC table id from SOS; a
    // duplicate-Cs SOS could otherwise leave entries uninitialized
    int predictor = 1;  // SOS Ss
    int pt = 0;         // SOS Al (point transform)
    int restart_interval = 0;
    const uint8_t* entropy = nullptr;  // start of entropy-coded data
};

inline int rd16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Parse markers up to and including the SOS header.  Fills `fr` and
// `tables`; leaves fr.entropy at the first entropy byte.
int parse_headers(const uint8_t* data, uint32_t len, Frame& fr, Huff tables[4]) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // SOI
    uint32_t pos = 2;
    bool have_sof = false;
    while (pos + 4 <= len) {
        if (data[pos] != 0xFF) return -1;
        while (pos < len && data[pos] == 0xFF) pos++;  // fill bytes allowed
        if (pos >= len) return -1;
        uint8_t m = data[pos++];
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // standalone
        if (pos + 2 > len) return -1;
        uint32_t seglen = rd16(data + pos);
        if (seglen < 2 || pos + seglen > len) return -1;
        const uint8_t* seg = data + pos + 2;
        uint32_t segbytes = seglen - 2;
        if (m == 0xC3) {  // SOF3: the lossless frame
            if (segbytes < 6) return -1;
            fr.precision = seg[0];
            fr.height = rd16(seg + 1);
            fr.width = rd16(seg + 3);
            fr.ncomp = seg[5];
            if (fr.precision < 2 || fr.precision > 16) return -2;
            if (fr.ncomp < 1 || fr.ncomp > 4) return -2;
            if (segbytes < 6u + 3u * fr.ncomp) return -1;
            for (int c = 0; c < fr.ncomp; c++) {
                fr.comp_id[c] = seg[6 + 3 * c];
                int hv = seg[7 + 3 * c];
                if (hv != 0x11) return -2;  // only H=V=1 sampling
            }
            have_sof = true;
        } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
            return -2;  // some other (lossy) SOF: not lossless JPEG
        } else if (m == 0xC4) {  // DHT: one or more tables
            uint32_t o = 0;
            while (o + 17 <= segbytes) {
                int tc_th = seg[o];
                int th = tc_th & 0x0F;
                // lossless uses class 0; some writers set class anyway
                uint8_t bits[17] = {0};
                int total = 0;
                for (int l = 1; l <= 16; l++) {
                    bits[l] = seg[o + l];
                    total += bits[l];
                }
                if (total > 256 || o + 17 + total > segbytes) return -1;
                if (th > 3) return -1;
                for (int i = 0; i < total; i++) tables[th].vals[i] = seg[o + 17 + i];
                tables[th].build(bits);
                o += 17 + total;
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
                if (td > 3) return -1;  // only 4 table slots exist
                int found = -1;
                for (int c = 0; c < fr.ncomp; c++)
                    if (fr.comp_id[c] == cs) found = c;
                if (found < 0) return -1;
                fr.comp_table[found] = td;
            }
            for (int c = 0; c < fr.ncomp; c++)
                if (fr.comp_table[c] < 0) return -1;  // unassigned comp
            fr.predictor = seg[1 + 2 * ns];      // Ss
            fr.pt = seg[3 + 2 * ns] & 0x0F;      // Al
            if (fr.predictor < 1 || fr.predictor > 7) return -2;
            fr.entropy = data + pos + seglen;
            return 0;
        } else if (m == 0xD9) {
            return -1;  // EOI before any scan
        }
        // APPn / COM / DNL / anything else with a length: skip
        pos += seglen;
    }
    return -1;
}

}  // namespace

extern "C" {

int ljpeg_info(const uint8_t* data, uint32_t len, uint32_t info[4]) {
    Frame fr;
    Huff tables[4];
    int rc = parse_headers(data, len, fr, tables);
    if (rc != 0) return rc;
    info[0] = (uint32_t)fr.width;
    info[1] = (uint32_t)fr.height;
    info[2] = (uint32_t)fr.ncomp;
    info[3] = (uint32_t)fr.precision;
    return 0;
}

int ljpeg_decode(const uint8_t* data, uint32_t len, uint16_t* out, uint64_t cap) {
    Frame fr;
    Huff tables[4];
    int rc = parse_headers(data, len, fr, tables);
    if (rc != 0) return rc;
    const int W = fr.width, H = fr.height, NC = fr.ncomp;
    const uint64_t total = (uint64_t)W * H * NC;
    if (total == 0) return -1;
    // Mid-row restarts (DRI not a multiple of the MCUs per row) hit a
    // decoder-divergent corner of T.81 (Rb prediction across a restart on
    // the following row) that no verified encoder exercises; stay inside
    // the validated envelope and report them as unsupported.
    if (fr.restart_interval && fr.restart_interval % W != 0) return -2;
    if (cap < total) return -4;
    for (int c = 0; c < NC; c++)
        if (!tables[fr.comp_table[c]].present) return -1;
    // T.81 requires Pt < P; a malformed stream with Pt >= P would make the
    // default-predictor shift below negative (undefined behavior)
    if (fr.pt < 0 || fr.pt >= fr.precision) return -1;

    BitReader br(fr.entropy, data + len);
    const int defval = 1 << (fr.precision - fr.pt - 1);
    const int rowlen = W * NC;
    // Two reconstruction rows (int32: values fit in 16 bits but predictor
    // arithmetic can transiently exceed them).
    int32_t* rows = new int32_t[2 * (size_t)rowlen];
    int32_t* prev = rows;
    int32_t* curr = rows + rowlen;

    // Restart intervals restart prediction: the first sample of each
    // component after a restart uses the default, and the remainder of
    // that sample row falls back to 1-D (Ra) prediction, exactly as at
    // the start of the scan (T.81 H.2.1/H.2.4).
    int mcus_until_restart = fr.restart_interval;
    int next_rst = 0;
    bool fresh = true;        // at start-of-scan / just restarted
    int fresh_row = 0;        // row where the current "first line" began
    int fresh_col = 0;        // column where it began
    int err = 0;

    for (int y = 0; y < H && !err; y++) {
        for (int x = 0; x < W && !err; x++) {
            if (fr.restart_interval && mcus_until_restart == 0) {
                int idx = br.read_restart();
                if (idx < 0 || idx != next_rst) { err = -3; break; }
                next_rst = (next_rst + 1) & 7;
                mcus_until_restart = fr.restart_interval;
                fresh = true;
                fresh_row = y;
                fresh_col = x;
            }
            for (int c = 0; c < NC; c++) {
                const Huff& h = tables[fr.comp_table[c]];
                int ssss = decode_huff(h, br);
                if (ssss < 0 || ssss > 16) { err = -3; break; }
                int diff;
                if (ssss == 16) {
                    diff = 32768;  // no extra bits (T.81 H.1.2.2)
                } else if (ssss == 0) {
                    diff = 0;
                } else {
                    diff = extend(br.get_bits(ssss), ssss);
                }
                if (br.fabricated) { err = -3; break; }  // bits past data/marker
                int pred;
                const int i = x * NC + c;
                if (fresh && y == fresh_row && x == fresh_col) {
                    pred = defval;
                } else if (fresh && y == fresh_row) {
                    pred = curr[i - NC];  // Ra: rest of the (re)started line
                } else if (x == 0) {
                    pred = prev[i];  // Rb at the start of every other line
                } else {
                    const int ra = curr[i - NC], rb = prev[i], rc_ = prev[i - NC];
                    switch (fr.predictor) {
                        case 1: pred = ra; break;
                        case 2: pred = rb; break;
                        case 3: pred = rc_; break;
                        case 4: pred = ra + rb - rc_; break;
                        case 5: pred = ra + ((rb - rc_) >> 1); break;
                        case 6: pred = rb + ((ra - rc_) >> 1); break;
                        default: pred = (ra + rb) >> 1; break;  // 7
                    }
                }
                int val = (pred + diff) & 0xFFFF;
                curr[i] = val;
                out[(uint64_t)y * rowlen + i] = (uint16_t)(val << fr.pt);
            }
            if (fr.restart_interval) mcus_until_restart--;
        }
        // The (re)started "first line" ends with its row; normal 2-D
        // prediction resumes on the next row.
        if (fresh && y == fresh_row) fresh = false;
        int32_t* t = prev;
        prev = curr;
        curr = t;
    }
    delete[] rows;
    return err;
}

}  // extern "C"
