"""Content-Aware Fill: instant brush + PatchMatch exemplar inpainting
(paintfe_tpu.ops.inpaint counterpart).

Behavioral contract: src/ops/inpaint.rs — quality tiers (:13-47), instant
ring-sampling brush (:76-192), onion-peeling PatchMatch (:199-519).

Both run in the port's native C++ (native/inpaint.cpp, the JAX package's
source, built by g++ into the port's one host library): the onion peel is
serial, data-dependent search where each fill feeds the next, host work in
the reference as in the JAX package, on the layers' host arrays.  There is
no fallback: a failed build raises (native.load), and `_patchmatch_py` /
`_instant_brush_py` are plain oracles that only the tests call.
"""

from __future__ import annotations

import ctypes
import enum

import numpy as np

from paintfe_tpu_torch import native

f32 = np.float32


class ContentAwareQuality(enum.Enum):
    INSTANT = "instant"
    BALANCED = "balanced"       # PatchMatch-lite: 3 iters, 5x5 patch
    HIGH_QUALITY = "high_quality"  # 6 iters, 7x7 patch

    @property
    def patchmatch_iters(self) -> int:
        return {"instant": 0, "balanced": 3, "high_quality": 6}[self.value]

    @property
    def patch_size(self) -> int:
        return {"instant": 0, "balanced": 5, "high_quality": 7}[self.value]


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def fill_region_patchmatch(src: np.ndarray, hole_mask: np.ndarray,
                           patch_size: int = 5, iterations: int = 3) -> np.ndarray:
    """Exemplar fill; deterministic (coordinate-seeded hashes/LCG)."""
    src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape[:2]
    mask = np.ascontiguousarray(hole_mask, np.uint8).reshape(h, w)
    out = src.copy()
    native.load().patchmatch_fill(_u8ptr(src), _u8ptr(mask), _u8ptr(out),
                                  w, h, int(patch_size), int(iterations))
    return out


def inpaint_instant_brush(src: np.ndarray, hole_mask: np.ndarray,
                          out: np.ndarray, cx: float, cy: float,
                          brush_radius: float, sample_radius: float,
                          hardness: float) -> np.ndarray:
    """Weighted spiral ring sampling within the brush radius; mutates and
    returns `out` (a copy of it when it is not C-contiguous)."""
    src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape[:2]
    mask = np.ascontiguousarray(hole_mask, np.uint8).reshape(h, w)
    if not out.flags["C_CONTIGUOUS"]:
        out = np.ascontiguousarray(out)
    native.load().inpaint_instant_brush(_u8ptr(src), _u8ptr(mask), _u8ptr(out),
                                        w, h, f32(cx), f32(cy), f32(brush_radius),
                                        f32(sample_radius), f32(hardness))
    return out


# ---------------------------------------------------------------------------
# Plain Python versions of the same algorithm: the oracles the tests hold the
# C++ against.  No entry point calls them.
# ---------------------------------------------------------------------------

U64 = (1 << 64) - 1


def _ssd_masked(img, mask, ax, ay, bx, by, half, min_valid, w, h):
    ssd = f32(0.0)
    count = 0
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            apx, apy = ax + dx, ay + dy
            bpx, bpy = bx + dx, by + dy
            if not (0 <= apx < w and 0 <= apy < h):
                continue
            if not (0 <= bpx < w and 0 <= bpy < h):
                continue
            if mask[apy, apx] > 0 or mask[bpy, bpx] > 0:
                continue
            pa = img[apy, apx]
            pb = img[bpy, bpx]
            for c in range(3):
                d = f32(int(pa[c]) - int(pb[c]))
                ssd = f32(ssd + d * d)
            count += 1
    if count < min_valid:
        return np.inf
    # f32 divide like native inpaint.cpp:50 (ssd / (float)count): an f64
    # quotient can order two f32-equal candidates differently
    return f32(ssd / f32(count))


def _patchmatch_py(src, mask_in, patch_size, iterations):
    h, w = src.shape[:2]
    ps = max(patch_size, 3)
    half = ps // 2
    min_valid = max((half * 2 + 1) ** 2, 4) // 4
    max_radius = float(max(w, h))
    out = src.copy()
    live = mask_in.copy()
    nnf_ox = np.zeros((h, w), np.int64)
    nnf_oy = np.zeros((h, w), np.int64)
    nnf_ssd = np.full((h, w), np.inf)

    source = [(x, y) for y in range(h) for x in range(w) if mask_in[y, x] == 0]
    if not source:
        return out

    for _peel in range((max(w, h) + 1) * 2):
        interior = live > 0
        nb = np.zeros((h, w), bool)
        nb[:, 1:] |= live[:, :-1] == 0
        nb[:, :-1] |= live[:, 1:] == 0
        nb[1:, :] |= live[:-1, :] == 0
        nb[:-1, :] |= live[1:, :] == 0
        bmask = interior & nb
        boundary = [(x, y) for y in range(h) for x in range(w) if bmask[y, x]]
        if not boundary:
            break
        src_count = len(source)

        for hx, hy in boundary:
            seed = ((hx * 7919) + (hy * 6271)) % src_count
            sx, sy = source[seed]
            nnf_ox[hy, hx] = sx - hx
            nnf_oy[hy, hx] = sy - hy
            nnf_ssd[hy, hx] = _ssd_masked(out, live, hx, hy, sx, sy, half, min_valid, w, h)
            rng = ((hx * 1234567891) + (hy * 987654321)) & U64
            for _ in range(4):
                rng = (rng * 6364136223846793005 + 1) & U64
                si = (rng >> 33) % src_count
                tx, ty = source[si]
                s2 = _ssd_masked(out, live, hx, hy, tx, ty, half, min_valid, w, h)
                if s2 < nnf_ssd[hy, hx]:
                    nnf_ox[hy, hx] = tx - hx
                    nnf_oy[hy, hx] = ty - hy
                    nnf_ssd[hy, hx] = s2

        pm_iters = 2 if iterations <= 3 else 4
        for it in range(pm_iters):
            order = boundary if it % 2 == 0 else boundary[::-1]
            nbs = [(-1, 0), (0, -1)] if it % 2 == 0 else [(1, 0), (0, 1)]
            for hx, hy in order:
                best_ox, best_oy = int(nnf_ox[hy, hx]), int(nnf_oy[hy, hx])
                best = nnf_ssd[hy, hx]
                for ndx, ndy in nbs:
                    nx, ny = hx + ndx, hy + ndy
                    if not (0 <= nx < w and 0 <= ny < h):
                        continue
                    if np.isinf(nnf_ssd[ny, nx]):
                        continue
                    cx2 = hx + int(nnf_ox[ny, nx])
                    cy2 = hy + int(nnf_oy[ny, nx])
                    if not (0 <= cx2 < w and 0 <= cy2 < h) or live[cy2, cx2] > 0:
                        continue
                    s = _ssd_masked(out, live, hx, hy, cx2, cy2, half, min_valid, w, h)
                    if s < best:
                        best, best_ox, best_oy = s, cx2 - hx, cy2 - hy
                rng = (hx * 6364136223846793005 + hy * 982451653 + it * 1234567891) & U64
                search_r = f32(max_radius)  # f32 like the native search_r
                while search_r >= 1.0:
                    rng = (rng * 6364136223846793005 + 1442695040888963407) & U64
                    ra = f32((rng >> 33) & 0xFFFFFFFF) / f32(0xFFFFFFFF)
                    rng = (rng * 6364136223846793005 + 1442695040888963407) & U64
                    rb = f32((rng >> 33) & 0xFFFFFFFF) / f32(0xFFFFFFFF)
                    cx2 = int(np.floor(abs(hx + best_ox + (ra * 2 - 1) * search_r) + 0.5)
                              * np.sign(hx + best_ox + (ra * 2 - 1) * search_r + 1e-30))
                    cy2 = int(np.floor(abs(hy + best_oy + (rb * 2 - 1) * search_r) + 0.5)
                              * np.sign(hy + best_oy + (rb * 2 - 1) * search_r + 1e-30))
                    if 0 <= cx2 < w and 0 <= cy2 < h and live[cy2, cx2] == 0:
                        s = _ssd_masked(out, live, hx, hy, cx2, cy2, half, min_valid, w, h)
                        if s < best:
                            best, best_ox, best_oy = s, cx2 - hx, cy2 - hy
                    search_r = f32(search_r * f32(0.5))
                nnf_ox[hy, hx], nnf_oy[hy, hx], nnf_ssd[hy, hx] = best_ox, best_oy, best

        fills = []
        for hx, hy in boundary:
            if np.isinf(nnf_ssd[hy, hx]):
                continue
            sx = hx + int(nnf_ox[hy, hx])
            sy = hy + int(nnf_oy[hy, hx])
            if not (0 <= sx < w and 0 <= sy < h) or live[sy, sx] > 0:
                continue
            fills.append((hx, hy, out[sy, sx].copy()))
        for x, y, px in fills:
            out[y, x] = px
        for x, y in boundary:
            live[y, x] = 0
            source.append((x, y))
    return out


def _instant_brush_py(src, mask, out, cx, cy, brush_radius, sample_radius, hardness):
    h, w = src.shape[:2]
    r = f32(max(brush_radius, 1.0))
    inner_r = f32(sample_radius) * f32(0.25)
    outer_r = f32(sample_radius)
    n_cand = 32
    sig = f32(2500.0)
    min_x = int(max(cx - r, 0.0))
    max_x = min(int(np.ceil(cx + r)), w - 1)
    min_y = int(max(cy - r, 0.0))
    max_y = min(int(np.ceil(cy + r)), h - 1)
    for y in range(min_y, max_y + 1):
        for x in range(min_x, max_x + 1):
            if mask[y, x] == 0:
                continue
            dx, dy = f32(x) - f32(cx), f32(y) - f32(cy)
            dist = f32(np.sqrt(dx * dx + dy * dy))
            if dist > r:
                continue
            t = min(max(dist / r, 0.0), 1.0)
            hard_t = min(max(hardness * 0.9 + 0.1, 0.0), 1.0)
            if t < hard_t:
                ga = 1.0
            else:
                s = (t - hard_t) / (1.0 - hard_t + 1e-6)
                ga = 1.0 - s * s * (3.0 - 2.0 * s)
            if ga < 0.01:
                continue
            ref = src[y, x].astype(f32)
            sums = np.zeros(4, f32)
            wt = f32(0.0)
            for i in range(n_cand):
                ang = f32(i) * (f32(2 * np.pi) / f32(n_cand))
                rr = inner_r + (outer_r - inner_r) * (f32(i) / f32(n_cand - 1))
                # roundf parity: half-AWAY-from-zero like the native/
                # reference path (np.round is banker's — 2.5 would pick
                # the other sample pixel)
                vx = x + np.cos(ang) * rr
                vy = y + np.sin(ang) * rr
                sx = int(np.floor(vx + 0.5)) if vx >= 0 else -int(np.floor(-vx + 0.5))
                sy = int(np.floor(vy + 0.5)) if vy >= 0 else -int(np.floor(-vy + 0.5))
                if not (0 <= sx < w and 0 <= sy < h) or mask[sy, sx] > 0:
                    continue
                sp = src[sy, sx].astype(f32)
                d2 = ((sp[0] - ref[0]) ** 2 + (sp[1] - ref[1]) ** 2 + (sp[2] - ref[2]) ** 2)
                wc = f32(np.exp(-d2 / sig))
                sums += sp * wc
                wt = f32(wt + wc)
            if wt < 1e-6:
                continue
            # the reference truncates the weighted mean to u8 BEFORE the
            # lerp (clamp255/`as u8` in native/inpaint.cpp and the Rust
            # core); lerping the fractional mean drifts channels by one
            fill = np.trunc(np.clip(sums / wt, 0, 255))
            ea = out[y, x, 3] / 255.0
            if ga >= ea:
                e = out[y, x].astype(f32)
                out[y, x, 0] = np.uint8(min(max(e[0] + (fill[0] - e[0]) * ga, 0), 255))
                out[y, x, 1] = np.uint8(min(max(e[1] + (fill[1] - e[1]) * ga, 0), 255))
                out[y, x, 2] = np.uint8(min(max(e[2] + (fill[2] - e[2]) * ga, 0), 255))
                out[y, x, 3] = np.uint8(ga * 255.0)
    return out
