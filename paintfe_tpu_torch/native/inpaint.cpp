// Native inpainting runtime: Content-Aware Fill.
//
// Behavioral contract: src/ops/inpaint.rs — instant ring-sampling brush
// (:76-192) and onion-peeling + PatchMatch exemplar fill (:199-519).
// Deterministic: hash/LCG seeds derive from coordinates, so output is
// reproducible and matches the reference's golden images.
//
// This is host-side, data-dependent, iterative work (a serial onion peel
// whose every fill feeds the next search), so it lives in native code like
// the reference's Rust core; the port keeps the JAX package's source as it
// is, so the same host gives the same bytes.  Compile with
// -ffp-contract=off: f32 parity requires no FMA contraction.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <limits>

extern "C" {

static inline bool in_bounds(int32_t x, int32_t y, int32_t w, int32_t h) {
    return x >= 0 && y >= 0 && x < w && y < h;
}

// Masked SSD between patches at (ax,ay) and (bx,by); hole pixels excluded on
// both sides; MAX when fewer than min_valid pairs.
static float patch_ssd_masked(const uint8_t* img, const uint8_t* mask,
                              int32_t w, int32_t h,
                              int32_t ax, int32_t ay, int32_t bx, int32_t by,
                              int32_t half, size_t min_valid) {
    float ssd = 0.0f;
    size_t count = 0;
    for (int32_t dy = -half; dy <= half; ++dy) {
        for (int32_t dx = -half; dx <= half; ++dx) {
            int32_t apx = ax + dx, apy = ay + dy;
            int32_t bpx = bx + dx, bpy = by + dy;
            if (!in_bounds(apx, apy, w, h) || !in_bounds(bpx, bpy, w, h)) continue;
            if (mask[(size_t)apy * w + apx] > 0) continue;
            if (mask[(size_t)bpy * w + bpx] > 0) continue;
            const uint8_t* pa = img + ((size_t)apy * w + apx) * 4;
            const uint8_t* pb = img + ((size_t)bpy * w + bpx) * 4;
            for (int c = 0; c < 3; ++c) {
                float d = (float)pa[c] - (float)pb[c];
                ssd += d * d;
            }
            ++count;
        }
    }
    if (count < min_valid) return std::numeric_limits<float>::max();
    return ssd / (float)count;
}

static void patchmatch_pass(const uint8_t* img, const uint8_t* mask,
                            int32_t w, int32_t h,
                            const std::vector<std::pair<uint32_t, uint32_t>>& pixels,
                            std::vector<int32_t>& nnf_ox,
                            std::vector<int32_t>& nnf_oy,
                            std::vector<float>& nnf_ssd,
                            int32_t half, size_t min_valid,
                            float max_radius, size_t iter) {
    const float FMAX = std::numeric_limits<float>::max();
    bool forward = (iter % 2) == 0;
    size_t n = pixels.size();
    for (size_t k = 0; k < n; ++k) {
        size_t i = forward ? k : (n - 1 - k);
        uint32_t hx = pixels[i].first, hy = pixels[i].second;
        size_t idx = (size_t)hy * w + hx;
        int32_t best_ox = nnf_ox[idx];
        int32_t best_oy = nnf_oy[idx];
        float best_ssd = nnf_ssd[idx];

        const int32_t fwd_nb[2][2] = {{-1, 0}, {0, -1}};
        const int32_t bwd_nb[2][2] = {{1, 0}, {0, 1}};
        const int32_t(*nb)[2] = forward ? fwd_nb : bwd_nb;
        for (int j = 0; j < 2; ++j) {
            int32_t nx = (int32_t)hx + nb[j][0];
            int32_t ny = (int32_t)hy + nb[j][1];
            if (!in_bounds(nx, ny, w, h)) continue;
            size_t ni = (size_t)ny * w + nx;
            if (nnf_ssd[ni] == FMAX) continue;
            int32_t cx = (int32_t)hx + nnf_ox[ni];
            int32_t cy = (int32_t)hy + nnf_oy[ni];
            if (!in_bounds(cx, cy, w, h)) continue;
            if (mask[(size_t)cy * w + cx] > 0) continue;
            float ssd = patch_ssd_masked(img, mask, w, h, (int32_t)hx, (int32_t)hy,
                                         cx, cy, half, min_valid);
            if (ssd < best_ssd) {
                best_ssd = ssd;
                best_ox = cx - (int32_t)hx;
                best_oy = cy - (int32_t)hy;
            }
        }

        // LCG random search, radius halving
        uint64_t rng = (uint64_t)hx * 6364136223846793005ULL
                     + (uint64_t)hy * 982451653ULL
                     + (uint64_t)iter * 1234567891ULL;
        float search_r = max_radius;
        const float U32_MAX_F = (float)0xFFFFFFFFu;
        while (search_r >= 1.0f) {
            rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
            float ra = (float)(uint32_t)(rng >> 33) / U32_MAX_F;
            rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
            float rb = (float)(uint32_t)(rng >> 33) / U32_MAX_F;
            int32_t cx = (int32_t)std::roundf((float)hx + (float)best_ox + (ra * 2.0f - 1.0f) * search_r);
            int32_t cy = (int32_t)std::roundf((float)hy + (float)best_oy + (rb * 2.0f - 1.0f) * search_r);
            if (in_bounds(cx, cy, w, h) && mask[(size_t)cy * w + cx] == 0) {
                float ssd = patch_ssd_masked(img, mask, w, h, (int32_t)hx, (int32_t)hy,
                                             cx, cy, half, min_valid);
                if (ssd < best_ssd) {
                    best_ssd = ssd;
                    best_ox = cx - (int32_t)hx;
                    best_oy = cy - (int32_t)hy;
                }
            }
            search_r *= 0.5f;
        }

        nnf_ox[idx] = best_ox;
        nnf_oy[idx] = best_oy;
        nnf_ssd[idx] = best_ssd;
    }
}

static bool is_boundary_hole(const uint8_t* mask, int32_t w, int32_t h,
                             uint32_t x, uint32_t y) {
    if (mask[(size_t)y * w + x] == 0) return false;
    const int32_t nb[4][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}};
    for (int j = 0; j < 4; ++j) {
        int32_t nx = (int32_t)x + nb[j][0];
        int32_t ny = (int32_t)y + nb[j][1];
        if (in_bounds(nx, ny, w, h) && mask[(size_t)ny * w + nx] == 0) return true;
    }
    return false;
}

// Onion-peeling + PatchMatch fill.  src/out: RGBA u8 row-major [h*w*4];
// mask: u8 [h*w], >0 = hole.  out must be a copy of src on entry.
void patchmatch_fill(const uint8_t* src, const uint8_t* mask_in, uint8_t* out,
                     uint32_t w, uint32_t h, uint32_t patch_size,
                     uint32_t iterations) {
    const float FMAX = std::numeric_limits<float>::max();
    int32_t ps = (int32_t)(patch_size < 3 ? 3 : patch_size);
    int32_t half = ps / 2;
    size_t side = (size_t)half * 2 + 1;
    size_t min_valid_base = side * side;
    size_t min_valid = (min_valid_base < 4 ? 4 : min_valid_base) / 4;
    float max_radius = (float)(w > h ? w : h);
    size_t total = (size_t)w * h;

    std::memcpy(out, src, total * 4);
    std::vector<uint8_t> live_mask(mask_in, mask_in + total);
    std::vector<int32_t> nnf_ox(total, 0), nnf_oy(total, 0);
    std::vector<float> nnf_ssd(total, FMAX);

    std::vector<std::pair<uint32_t, uint32_t>> source_pixels;
    source_pixels.reserve(total);
    for (uint32_t y = 0; y < h; ++y)
        for (uint32_t x = 0; x < w; ++x)
            if (mask_in[(size_t)y * w + x] == 0) source_pixels.emplace_back(x, y);
    if (source_pixels.empty()) return;

    size_t max_peel = ((size_t)(w > h ? w : h) + 1) * 2;
    for (size_t peel = 0; peel < max_peel; ++peel) {
        std::vector<std::pair<uint32_t, uint32_t>> boundary;
        for (uint32_t y = 0; y < h; ++y)
            for (uint32_t x = 0; x < w; ++x)
                if (is_boundary_hole(live_mask.data(), w, h, x, y))
                    boundary.emplace_back(x, y);
        if (boundary.empty()) break;

        size_t src_count = source_pixels.size();

        for (auto& p : boundary) {
            uint32_t hx = p.first, hy = p.second;
            size_t seed = ((size_t)hx * 7919 + (size_t)hy * 6271) % src_count;
            uint32_t sx = source_pixels[seed].first, sy = source_pixels[seed].second;
            float ssd = patch_ssd_masked(out, live_mask.data(), w, h,
                                         (int32_t)hx, (int32_t)hy,
                                         (int32_t)sx, (int32_t)sy, half, min_valid);
            size_t idx = (size_t)hy * w + hx;
            nnf_ox[idx] = (int32_t)sx - (int32_t)hx;
            nnf_oy[idx] = (int32_t)sy - (int32_t)hy;
            nnf_ssd[idx] = ssd;

            uint64_t rng = (uint64_t)hx * 1234567891ULL + (uint64_t)hy * 987654321ULL;
            for (int j = 0; j < 4; ++j) {
                rng = rng * 6364136223846793005ULL + 1ULL;
                size_t si = (size_t)(uint32_t)(rng >> 33) % src_count;
                uint32_t tx = source_pixels[si].first, ty = source_pixels[si].second;
                float s2 = patch_ssd_masked(out, live_mask.data(), w, h,
                                            (int32_t)hx, (int32_t)hy,
                                            (int32_t)tx, (int32_t)ty, half, min_valid);
                if (s2 < nnf_ssd[idx]) {
                    nnf_ox[idx] = (int32_t)tx - (int32_t)hx;
                    nnf_oy[idx] = (int32_t)ty - (int32_t)hy;
                    nnf_ssd[idx] = s2;
                }
            }
        }

        size_t pm_iters = iterations <= 3 ? 2 : 4;
        for (size_t it = 0; it < pm_iters; ++it)
            patchmatch_pass(out, live_mask.data(), w, h, boundary,
                            nnf_ox, nnf_oy, nnf_ssd, half, min_valid,
                            max_radius, it);

        // Fill (two-phase, like the reference's collect-then-write)
        std::vector<std::pair<size_t, uint32_t>> fills;  // (dst idx, packed rgba)
        for (auto& p : boundary) {
            uint32_t hx = p.first, hy = p.second;
            size_t idx = (size_t)hy * w + hx;
            if (nnf_ssd[idx] == FMAX) continue;
            int32_t sx = (int32_t)hx + nnf_ox[idx];
            int32_t sy = (int32_t)hy + nnf_oy[idx];
            if (!in_bounds(sx, sy, (int32_t)w, (int32_t)h)) continue;
            if (live_mask[(size_t)sy * w + sx] > 0) continue;
            uint32_t px;
            std::memcpy(&px, out + ((size_t)sy * w + sx) * 4, 4);
            fills.emplace_back(idx, px);
        }
        for (auto& f : fills) std::memcpy(out + f.first * 4, &f.second, 4);

        for (auto& p : boundary) {
            live_mask[(size_t)p.second * w + p.first] = 0;
            source_pixels.emplace_back(p.first, p.second);
        }
    }
}

// Instant ring-sampling brush (inpaint.rs:76-192).  out modified in place.
void inpaint_instant_brush(const uint8_t* src, const uint8_t* hole_mask,
                           uint8_t* out, uint32_t w, uint32_t h,
                           float cx, float cy, float brush_radius,
                           float sample_radius, float hardness) {
    const float TAU = 6.2831855f;
    float r = brush_radius > 1.0f ? brush_radius : 1.0f;
    float inner_r = sample_radius * 0.25f;
    float outer_r = sample_radius;
    const int num_candidates = 32;
    const float sigma_color_sq = 50.0f * 50.0f;

    if (w == 0 || h == 0) return;  // `> w - 1` on unsigned 0 would wrap
    float fx0 = cx - r; if (fx0 < 0.0f) fx0 = 0.0f;
    uint32_t min_x = (uint32_t)fx0;
    // saturate the float->u32 casts like Rust `as u32` (a negative
    // cx + r is UB under a plain C cast)
    float fx1 = std::ceil(cx + r); if (fx1 < 0.0f) fx1 = 0.0f;
    uint32_t max_x = (uint32_t)fx1; if (max_x > w - 1) max_x = w - 1;
    float fy0 = cy - r; if (fy0 < 0.0f) fy0 = 0.0f;
    uint32_t min_y = (uint32_t)fy0;
    float fy1 = std::ceil(cy + r); if (fy1 < 0.0f) fy1 = 0.0f;
    uint32_t max_y = (uint32_t)fy1; if (max_y > h - 1) max_y = h - 1;

    for (uint32_t y = min_y; y <= max_y; ++y) {
        for (uint32_t x = min_x; x <= max_x; ++x) {
            if (hole_mask[(size_t)y * w + x] == 0) continue;
            float dx = (float)x - cx, dy = (float)y - cy;
            float dist = std::sqrt(dx * dx + dy * dy);
            if (dist > r) continue;

            float t = dist / r; if (t > 1.0f) t = 1.0f; if (t < 0.0f) t = 0.0f;
            float hard_t = hardness * 0.9f + 0.1f;
            if (hard_t > 1.0f) hard_t = 1.0f; if (hard_t < 0.0f) hard_t = 0.0f;
            float geom_alpha;
            if (t < hard_t) {
                geom_alpha = 1.0f;
            } else {
                float s = (t - hard_t) / (1.0f - hard_t + 1e-6f);
                geom_alpha = 1.0f - s * s * (3.0f - 2.0f * s);
            }
            if (geom_alpha < 0.01f) continue;

            const uint8_t* rp = src + ((size_t)y * w + x) * 4;
            float ref_r = rp[0], ref_g = rp[1], ref_b = rp[2];

            float sum_r = 0, sum_g = 0, sum_b = 0, sum_a = 0, weight_total = 0;
            for (int i = 0; i < num_candidates; ++i) {
                float angle = (float)i * (TAU / (float)num_candidates);
                float rr = inner_r + (outer_r - inner_r) * ((float)i / (float)(num_candidates - 1));
                int32_t sx = (int32_t)std::roundf((float)x + std::cos(angle) * rr);
                int32_t sy = (int32_t)std::roundf((float)y + std::sin(angle) * rr);
                if (!in_bounds(sx, sy, (int32_t)w, (int32_t)h)) continue;
                if (hole_mask[(size_t)sy * w + sx] > 0) continue;
                const uint8_t* sp = src + ((size_t)sy * w + sx) * 4;
                float dr = (float)sp[0] - ref_r;
                float dg = (float)sp[1] - ref_g;
                float db = (float)sp[2] - ref_b;
                float wc = std::exp(-(dr * dr + dg * dg + db * db) / sigma_color_sq);
                sum_r += (float)sp[0] * wc;
                sum_g += (float)sp[1] * wc;
                sum_b += (float)sp[2] * wc;
                sum_a += (float)sp[3] * wc;
                weight_total += wc;
            }
            if (weight_total < 1e-6f) continue;

            auto clamp255 = [](float v) -> uint8_t {
                if (v < 0.0f) v = 0.0f;
                if (v > 255.0f) v = 255.0f;
                return (uint8_t)v;  // truncating, like Rust `as u8`
            };
            uint8_t fr = clamp255(sum_r / weight_total);
            uint8_t fg = clamp255(sum_g / weight_total);
            uint8_t fb = clamp255(sum_b / weight_total);

            uint8_t* ep = out + ((size_t)y * w + x) * 4;
            float ea = (float)ep[3] / 255.0f;
            if (geom_alpha >= ea) {
                auto lerp_u8 = [&clamp255](uint8_t a, uint8_t b, float tt) -> uint8_t {
                    return clamp255((float)a + ((float)b - (float)a) * tt);
                };
                ep[0] = lerp_u8(ep[0], fr, geom_alpha);
                ep[1] = lerp_u8(ep[1], fg, geom_alpha);
                ep[2] = lerp_u8(ep[2], fb, geom_alpha);
                ep[3] = (uint8_t)(geom_alpha * 255.0f);
            }
        }
    }
}

}  // extern "C"
