// NeuQuant color quantization (Anthony Dekker, 1994), 4-channel RGBA
// variant in f64 — the algorithm family the reference uses for animated
// GIF palettes via the color_quant crate (src/io.rs:2960-2989:
// NeuQuant::new(samplefac, colors, rgba) + per-pixel index_of).
//
// Training is inherently sequential (each sample updates the winning
// neuron and its neighborhood before the next sample is drawn), so it
// lives here rather than in numpy: a 4K frame draws ~830k samples at
// samplefac=10.
//
// This is a from-scratch implementation of the published algorithm
// (network initialized along the grey diagonal with a dark-alpha ramp,
// prime-strided sampling, bias/freq contest, radius/alpha decay over 100
// cycles); nearest-palette lookup uses the same Manhattan metric the
// contest trains with.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kCycles = 100;
constexpr int kPrimes[4] = {499, 491, 487, 503};
constexpr double kBeta = 1.0 / 1024.0;
constexpr double kGamma = 1024.0;
constexpr double kBetaGamma = kBeta * kGamma;

struct Net {
    double v[256][4];
    double freq[256];
    double bias[256];
    int size;
};

int contest(Net& net, const double p[4]) {
    double bestd = 1e300, bestbiasd = 1e300;
    int bestpos = 0, bestbiaspos = 0;
    for (int i = 0; i < net.size; ++i) {
        double dist = std::fabs(net.v[i][0] - p[0]) +
                      std::fabs(net.v[i][1] - p[1]) +
                      std::fabs(net.v[i][2] - p[2]) +
                      std::fabs(net.v[i][3] - p[3]);
        if (dist < bestd) {
            bestd = dist;
            bestpos = i;
        }
        double biasdist = dist - net.bias[i];
        if (biasdist < bestbiasd) {
            bestbiasd = biasdist;
            bestbiaspos = i;
        }
        net.freq[i] -= kBeta * net.freq[i];
        net.bias[i] += kBetaGamma * net.freq[i];
    }
    net.freq[bestpos] += kBeta;
    net.bias[bestpos] -= kBetaGamma;
    return bestbiaspos;
}

void alter_single(Net& net, double alpha, int j, const double p[4]) {
    for (int c = 0; c < 4; ++c)
        net.v[j][c] -= alpha * (net.v[j][c] - p[c]);
}

void alter_neigh(Net& net, double alpha, int rad, int j, const double p[4]) {
    int lo = std::max(j - rad, -1);
    int hi = std::min(j + rad, net.size);
    double radsq = static_cast<double>(rad) * rad;
    for (int d = 1; d < rad; ++d) {
        double a = alpha * (radsq - static_cast<double>(d) * d) / radsq;
        int k = j + d;
        if (k < hi)
            for (int c = 0; c < 4; ++c)
                net.v[k][c] -= a * (net.v[k][c] - p[c]);
        int m = j - d;
        if (m > lo)
            for (int c = 0; c < 4; ++c)
                net.v[m][c] -= a * (net.v[m][c] - p[c]);
    }
}

}  // namespace

extern "C" int neuquant_quantize(const uint8_t* pixels, long long n_pixels,
                                 int samplefac, int colors,
                                 uint8_t* palette_out, uint8_t* indices_out) {
    if (n_pixels <= 0 || colors < 2 || colors > 256 || samplefac < 1 ||
        samplefac > 30)
        return -1;
    Net net;
    net.size = colors;
    for (int i = 0; i < colors; ++i) {
        double tmp = static_cast<double>(i) * 256.0 / colors;
        double a = i < 16 ? i * 16.0 : 255.0;  // dark-alpha ramp
        net.v[i][0] = net.v[i][1] = net.v[i][2] = tmp;
        net.v[i][3] = a;
        net.freq[i] = 1.0 / colors;
        net.bias[i] = 0.0;
    }

    // training: prime-strided sample walk with alpha/radius decay
    long long samplepixels = n_pixels / samplefac;
    if (samplepixels < 1) samplepixels = 1;
    long long delta = samplepixels / kCycles;
    if (delta < 1) delta = 1;
    const int radiusbiasshift = 6;
    int bias_radius = (colors / 8) << radiusbiasshift;
    const int radius_dec = 30;
    const int alphabiasshift = 10;
    const int init_alpha = 1 << alphabiasshift;
    int alpha_int = init_alpha;
    int alphadec = 30 + (samplefac - 1) / 3;
    int rad = bias_radius >> radiusbiasshift;
    if (rad <= 1) rad = 0;

    int step = kPrimes[3];
    for (int pi = 0; pi < 4; ++pi) {
        if (n_pixels % kPrimes[pi] != 0) {
            step = kPrimes[pi];
            break;
        }
    }
    long long pos = 0;
    for (long long i = 0; i < samplepixels;) {
        const uint8_t* px = pixels + 4 * pos;
        double p[4] = {static_cast<double>(px[0]), static_cast<double>(px[1]),
                       static_cast<double>(px[2]), static_cast<double>(px[3])};
        int j = contest(net, p);
        double alpha = static_cast<double>(alpha_int) / init_alpha;
        alter_single(net, alpha, j, p);
        if (rad > 0) alter_neigh(net, alpha, rad, j, p);
        pos += step;
        while (pos >= n_pixels) pos -= n_pixels;
        ++i;
        if (i % delta == 0) {
            alpha_int -= alpha_int / alphadec;
            bias_radius -= bias_radius / radius_dec;
            rad = bias_radius >> radiusbiasshift;
            if (rad <= 1) rad = 0;
        }
    }

    // colormap: rounded, clamped neurons, GREEN-SORTED like color_quant's
    // inxbuild (the reference's palette order is the sorted network; an
    // unsorted palette would emit different palette/index bytes)
    uint8_t raw[256][4];
    for (int i = 0; i < colors; ++i)
        for (int c = 0; c < 4; ++c)
            raw[i][c] = static_cast<uint8_t>(
                std::clamp(std::lround(net.v[i][c]), 0l, 255l));
    int order[256];
    for (int i = 0; i < colors; ++i) order[i] = i;
    std::stable_sort(order, order + colors,
                     [&raw](int a, int b) { return raw[a][1] < raw[b][1]; });
    uint8_t cmap[256][4];
    for (int i = 0; i < colors; ++i)
        for (int c = 0; c < 4; ++c) cmap[i][c] = raw[order[i]][c];
    for (int i = 0; i < colors; ++i)
        for (int c = 0; c < 4; ++c) palette_out[4 * i + c] = cmap[i][c];

    // per-pixel nearest palette entry (Manhattan over RGBA, first wins)
    for (long long k = 0; k < n_pixels; ++k) {
        const uint8_t* px = pixels + 4 * k;
        int best = 0;
        int bestd = 1 << 30;
        for (int i = 0; i < colors; ++i) {
            int d = std::abs(static_cast<int>(cmap[i][0]) - px[0]) +
                    std::abs(static_cast<int>(cmap[i][1]) - px[1]) +
                    std::abs(static_cast<int>(cmap[i][2]) - px[2]) +
                    std::abs(static_cast<int>(cmap[i][3]) - px[3]);
            if (d < bestd) {
                bestd = d;
                best = i;
            }
        }
        indices_out[k] = static_cast<uint8_t>(best);
    }
    return 0;
}
