"""Convolution and neighbourhood filters: the Gaussian, box and motion
blurs, sharpen, glow, the median and reduce-noise (paintfe_tpu.ops.filters
counterpart), and the bokeh and zoom blurs.

Behavioral contract: src/ops/filters.rs — separable Gaussian, kernel
truncated at ceil(3*sigma), H pass u8->f32, V pass f32->u8 round-half-up,
f32 sums in reference tap order; effects/blur.rs — box (u8 between the
passes, integer round-half-up) and motion blur (integer sums of line
samples); effects/stylize.rs — unsharp mask and glow over the Gaussian;
effects/noise.rs — per-channel median of the (2r+1)^2 window, edges
replicated, and the bilateral reduce-noise; effects/blur.rs — the bokeh
disc average (:22-115) and the zoom blur (:322-427).  The Gaussian runs
through the K-blur kernel wrapper (sharpen and glow included) and the
median through K-median's (ops/kernels.py); on a CPU tensor each takes its
plain version.
The rest is plain torch in the JAX package's expression order, over
[..., H, W, 4] tensors, and byte-equal to the JAX package, except
reduce-noise: its weight is an exp of a pixel-dependent argument, which
under the transcendental rule (ROADMAP C2) comes from a host table (f64
exp of each f32 argument, rounded once to f32), within 1 of the JAX
package's u8.  Glow divides by 255 truly, as the reference does, where
the JAX package multiplies by the reciprocal (ROADMAP C9): within 1.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import as_image, by_frames, pad_edges, window_sums
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.quant import ieee_div, round_half_away, round_u8, sqrt_f32

f32 = np.float32


def gaussian_kernel(sigma: float) -> np.ndarray:
    """1-D kernel truncated at ceil(3*sigma), normalized (f32 exact)."""
    radius = int(math.ceil(sigma * 3.0))
    if radius == 0:
        return np.ones(1, f32)
    xs = np.arange(2 * radius + 1, dtype=f32) - f32(radius)
    s2 = f32(2.0) * f32(sigma) * f32(sigma)
    k = np.exp(-xs * xs / s2).astype(f32)
    inv = f32(1.0) / f32(k.sum(dtype=f32))
    return (k * inv).astype(f32)


def gaussian_blur(img: torch.Tensor, sigma: float, mask=None) -> torch.Tensor:
    """Separable Gaussian blur of u8 [H, W, 4] or [B, H, W, 4]
    (filters.rs:242-316); masked-out pixels keep the input."""
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_fused

    return _masked(img, gaussian_blur_fused(img, float(sigma)), mask)


def gaussian_blur_with_selection(img: torch.Tensor, sigma: float,
                                 mask=None) -> torch.Tensor:
    """Selection-aware Gaussian: blur only the padded selection bbox, then
    copy selected pixels back (filters.rs:130-207).  The bbox is a host
    decision, and clamping happens at the cutout's edges like the
    reference's region cutout.  `mask` is u8 [H, W] (numpy), or None."""
    if mask is None:
        return gaussian_blur(img, sigma)
    m = np.asarray(mask)
    if not m.any():
        return img  # nothing selected
    ys, xs = np.nonzero(m)
    pad = int(math.ceil(sigma * 3.0))
    h, w = img.shape[:2]
    y0 = max(int(ys.min()) - pad, 0)
    y1 = min(int(ys.max()) + pad + 1, h)
    x0 = max(int(xs.min()) - pad, 0)
    x1 = min(int(xs.max()) + pad + 1, w)
    region = img[y0:y1, x0:x1].contiguous()
    blurred = gaussian_blur(region, sigma)
    sel = torch.from_numpy(m[y0:y1, x0:x1] > 0).to(img.device)
    out = img.clone()
    out[y0:y1, x0:x1] = torch.where(sel[..., None], blurred, region)
    return out


def to_radians_f32(deg) -> np.float32:
    """f32 deg->rad exactly like Rust f32::to_radians (mul by f32 PI/180)."""
    return f32(f32(deg) * (f32(np.pi) / f32(180.0)))


# ---------------------------------------------------------------------------
# Box
# ---------------------------------------------------------------------------


def box_blur(img: torch.Tensor, radius: float, mask=None) -> torch.Tensor:
    """Separable box blur of u8 [..., H, W, 4], u8 between the passes,
    integer round-half-up (effects/blur.rs:233-318)."""
    if radius < 0.5:
        return img
    r = int(math.ceil(radius))
    k = 2 * r + 1

    def run(x):
        h_pass = ((window_sums(x.int(), r, -2) + k // 2) // k).to(torch.uint8)
        return ((window_sums(h_pass.int(), r, -3) + k // 2) // k).to(torch.uint8)

    return _masked(img, by_frames(run, img), mask)


# ---------------------------------------------------------------------------
# Motion
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def motion_taps(angle_deg: float, distance: float, h: int, w: int):
    """The motion blur's sample columns and rows, one [W] and one [H]
    int64 array a tap, and the f32 reciprocal of the tap count.  The
    direction's cos and sin are host scalars, as in the JAX package."""
    angle = to_radians_f32(angle_deg)
    steps = int(math.ceil(distance))
    dx = f32(np.cos(angle))
    dy = f32(np.sin(angle))
    inv = f32(1.0) / f32(steps * 2 + 1)
    xs = np.arange(w, dtype=f32)
    ys = np.arange(h, dtype=f32)
    taps = []
    for i in range(-steps, steps + 1):
        sx = np.clip(round_half_away(xs + f32(i) * dx).astype(np.int32), 0, w - 1)
        sy = np.clip(round_half_away(ys + f32(i) * dy).astype(np.int32), 0, h - 1)
        taps.append((sx.astype(np.int64), sy.astype(np.int64)))
    return taps, inv


def motion_blur(img: torch.Tensor, angle_deg: float, distance: float,
                mask=None) -> torch.Tensor:
    """Directional line-sample average of u8 [..., H, W, 4]
    (effects/blur.rs:144-210): integer sums, then one f32 multiply by the
    reciprocal of the tap count, rounded half up."""
    if distance < 1.0:
        return img
    h, w = img.shape[-3], img.shape[-2]
    taps, inv = motion_taps(float(angle_deg), float(distance), h, w)
    idx = [(torch.from_numpy(sx).to(img.device), torch.from_numpy(sy).to(img.device))
           for sx, sy in taps]

    def run(x):
        src = x.int()
        acc = torch.zeros_like(src)
        for sx, sy in idx:
            acc += src.index_select(-3, sy).index_select(-2, sx)
        return round_u8(acc.float() * float(inv))

    return _masked(img, by_frames(run, img), mask)


# ---------------------------------------------------------------------------
# Bokeh (equal-weight disc)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def bokeh_spans(radius: float):
    """The disc of bokeh_blur as (r, [(dy, half-span)], f32 reciprocal of
    the tap count), in the JAX package's host f32 math."""
    r = int(math.ceil(radius))
    r2 = f32(radius) * f32(radius)
    spans = []
    count = 0
    for dyy in range(-r, r + 1):
        remaining = r2 - f32(dyy * dyy)
        if remaining >= 0.0:
            span = int(np.floor(np.sqrt(remaining)))
            spans.append((dyy, span))
            count += span * 2 + 1
    return r, spans, f32(1.0) / f32(count)


def bokeh_blur(img, radius: float, mask=None, device="cuda") -> torch.Tensor:
    """Exact equal-weight disc average (effects/blur.rs:22-115) of u8
    [..., H, W, 4] (a tensor, or numpy moved to `device`).  Each row of the
    disc is a difference of two x-prefix sums of the edge-padded image
    (int64: exact, so the sums equal the JAX package's u32 tap sums), then
    one f32 multiply by the reciprocal of the tap count, rounded half up."""
    x = as_image(img, device)
    if radius < 0.5:
        return x
    r, spans, inv = bokeh_spans(float(radius))
    inv = float(inv)

    def run(t):
        h, w = t.shape[-3], t.shape[-2]
        padded = pad_edges(pad_edges(t.long(), r, -3), r, -2)
        c = torch.cumsum(padded, dim=-2)
        c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
        acc = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
        for dyy, span in spans:
            rows = c[..., r + dyy:r + dyy + h, :, :]
            acc += rows[..., r + span + 1:r + span + 1 + w, :] - rows[..., r - span:r - span + w, :]
        return round_u8(acc.float() * inv)

    return _masked(x, by_frames(run, x), mask)


# ---------------------------------------------------------------------------
# Zoom (radial)
# ---------------------------------------------------------------------------


def zoom_blur(img, center_x=0.5, center_y=0.5, strength=0.3, samples=8,
              tint_color=(0.0, 0.0, 0.0, 0.0), tint_strength=0.0, mask=None,
              device="cuda") -> torch.Tensor:
    """Radial zoom streaks toward a normalized center (effects/blur.rs:322-427)
    of u8 [..., H, W, 4] (a tensor, or numpy moved to `device`).  The zoom
    map is separable: each sample is a take of rows then of columns at
    indices rounded half away from zero; integer sums, one f32 multiply by
    the reciprocal of the sample count, then the tint (its distance a
    correctly rounded sqrt, its divide a true divide), rounded half up."""
    x = as_image(img, device)
    if strength < 0.001:
        return x
    h, w = x.shape[-3], x.shape[-2]
    dev = x.device
    cx = f32(center_x) * f32(w)
    cy = f32(center_y) * f32(h)
    s = f32(np.clip(strength, 0.0, 0.99))
    n = max(int(samples), 2)
    inv_n = float(f32(1.0) / f32(n))
    corners = [(cx, cy), (f32(w) - cx, cy), (cx, f32(h) - cy), (f32(w) - cx, f32(h) - cy)]
    max_dist = max(max(float(np.sqrt(a * a + b * b)) for a, b in corners), 1.0)
    xs1 = torch.arange(w, dtype=torch.float32, device=dev)
    ys1 = torch.arange(h, dtype=torch.float32, device=dev)
    taps = []
    for i in range(n):
        t = float(f32(1.0) - s * (f32(i) / f32(n - 1)))
        sxv = torch.clamp(round_half_away(float(cx) + (xs1 - float(cx)) * t).int(), 0, w - 1)
        syv = torch.clamp(round_half_away(float(cy) + (ys1 - float(cy)) * t).int(), 0, h - 1)
        taps.append((syv.long(), sxv.long()))
    tint = None
    if tint_strength > 0.001:
        dx = xs1[None, :] - float(cx)
        dy = ys1[:, None] - float(cy)
        dist = sqrt_f32(dx * dx + dy * dy)
        tt = torch.clamp(1.0 - ieee_div(dist, float(f32(max_dist))), min=0.0) \
            * float(f32(tint_strength))
        tint_v = torch.from_numpy(np.asarray(tint_color, f32) * f32(255.0)).to(dev)
        tint = (tint_v, tt[..., None])

    def run(t):
        src = t.int()
        acc = torch.zeros_like(src)
        for syv, sxv in taps:
            acc += src.index_select(-3, syv).index_select(-2, sxv)
        out = acc.float() * inv_n
        if tint is not None:
            out = out + (tint[0] - out) * tint[1]
        return round_u8(out)

    return _masked(x, by_frames(run, x), mask)


# ---------------------------------------------------------------------------
# Unsharp mask / glow
# ---------------------------------------------------------------------------


def sharpen(img: torch.Tensor, amount: float, radius: float, mask=None) -> torch.Tensor:
    """Unsharp mask: out = src + amount*(src - gaussian(src, radius)); RGB
    only, alpha preserved (effects/stylize.rs:96-141).  The blur is one
    K-blur launch for the whole batch on the card."""
    blurred = gaussian_blur(img, radius)
    amt = float(f32(amount))

    def mix(src, blur):
        s = src[..., 0:3].float()
        rgb = round_u8(s + amt * (s - blur[..., 0:3].float()))
        return torch.cat([rgb, src[..., 3:4]], dim=-1)

    return _masked(img, by_frames(mix, img, blurred), mask)


def glow_mix(src: torch.Tensor, blur: torch.Tensor, intensity: float) -> torch.Tensor:
    """Glow's screen formula on u8 [..., 4] source and blur pixels:
    1-(1-s)(1-b*i) per RGB channel in [0,1], rounded half up, alpha of the
    source.  The divides by 255 are true divides, the reference's; the JAX
    package multiplies by the reciprocal (ROADMAP C9)."""
    inten = float(f32(intensity))
    s = ieee_div(src[..., 0:3].float(), 255.0)
    b = ieee_div(blur[..., 0:3].float(), 255.0)
    res = 1.0 - (1.0 - s) * (1.0 - b * inten)
    return torch.cat([round_u8(res * 255.0), src[..., 3:4]], dim=-1)


def glow(img: torch.Tensor, radius: float, intensity: float, mask=None) -> torch.Tensor:
    """Screen-blend of source with its blur scaled by intensity
    (effects/stylize.rs:26-72) of u8 [..., H, W, 4].  The blur is one
    K-blur launch for the whole batch on the card."""
    blurred = gaussian_blur(img, radius)
    out = by_frames(lambda src, blur: glow_mix(src, blur, intensity), img, blurred)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Median
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _oddeven_merge_network(n: int):
    """Batcher odd-even mergesort comparator list for n inputs (pairs i<j).
    O(n log^2 n) compare-exchanges; sorts any input exactly."""
    # Batcher's construction needs a power-of-two width; pad virtually and
    # drop comparators that touch the padding (padding sorts as +inf).
    m = 1
    while m < n:
        m *= 2
    comparators = []

    def merge(lo, nn, step):
        dbl = step * 2
        if dbl < nn:
            merge(lo, nn, dbl)
            merge(lo + step, nn, dbl)
            for i in range(lo + step, lo + nn - step, dbl):
                comparators.append((i, i + step))
        elif lo + step < lo + nn:
            comparators.append((lo, lo + step))

    def sort(lo, nn):
        if nn > 1:
            mid = nn // 2
            sort(lo, mid)
            sort(lo + mid, nn - mid)
            merge(lo, nn, 1)

    sort(0, m)
    return [(i, j) for (i, j) in comparators if i < n and j < n]


def median(img: torch.Tensor, radius: int, mask=None) -> torch.Tensor:
    """Per-channel window-sort median (effects/noise.rs:357-411) of u8
    [H, W, 4] or [B, H, W, 4], r = max(radius, 1); masked-out pixels keep
    the input.  On the card it always launches K-median."""
    from paintfe_tpu_torch.ops.kernels import median_kernel

    return _masked(img, median_kernel(img, max(int(radius), 1)), mask)


# ---------------------------------------------------------------------------
# Reduce-noise (bilateral)
# ---------------------------------------------------------------------------

# the range term's integer argument: a sum of three squared u8 differences
_MAX_SSD = 3 * 255 * 255


@functools.lru_cache(maxsize=4)
def reduce_noise_weights(strength: float, r: int):
    """The bilateral weights as a host table (ROADMAP C2): row k holds
    exp(-spatial_k - ssd / range_div) for every integer ssd in
    [0, 3 * 255^2], where spatial_k is the k-th distinct squared tap
    distance over 2 r^2.  The argument is computed in f32 in the JAX
    package's order, the exp is an f64 libm call of it rounded once to f32.
    Returns ({squared distance: row}, f32 table [rows, 195076])."""
    sigma_s = f32(r)
    sigma_r = f32(strength) * f32(2.55)
    spatial_div = f32(2.0) * sigma_s * sigma_s
    range_div = f32(2.0) * sigma_r * sigma_r + f32(0.001)
    d2 = sorted({dx * dx + dy * dy for dy in range(-r, r + 1) for dx in range(-r, r + 1)})
    rng = np.arange(_MAX_SSD + 1, dtype=f32) / range_div
    table = np.empty((len(d2), _MAX_SSD + 1), f32)
    for k, q in enumerate(d2):
        spatial = f32(q) / spatial_div
        table[k] = np.exp((-spatial - rng).astype(np.float64)).astype(f32)
    return {q: k for k, q in enumerate(d2)}, table


def reduce_noise(img: torch.Tensor, strength: float, radius: int, mask=None) -> torch.Tensor:
    """Bilateral filter of u8 [..., H, W, 4]: spatial sigma = radius, range
    sigma = strength*2.55 (effects/noise.rs:172-261).  Each tap's weight is
    a gather from reduce_noise_weights' table at the tap's integer squared
    colour distance; the weighted sums run in f32 in the reference's tap
    order."""
    r = max(int(radius), 1)
    rows, table = reduce_noise_weights(float(strength), r)
    weights = torch.from_numpy(table).to(img.device)

    def run(x):
        h, w = x.shape[-3], x.shape[-2]
        padded = pad_edges(pad_edges(x, r, -3), r, -2)
        c = x[..., 0:3].int()
        sums = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        wsum = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        for dyy in range(-r, r + 1):  # reference accumulation order
            row = padded[..., r + dyy:r + dyy + h, :, :]
            for dxx in range(-r, r + 1):
                p = row[..., r + dxx:r + dxx + w, :]
                diff = c - p[..., 0:3].int()
                ssd = (diff * diff).sum(dim=-1)
                weight = weights[rows[dxx * dxx + dyy * dyy]][ssd.long()]
                sums = sums + p.float() * weight[..., None]
                wsum = wsum + weight
        live = wsum > 0.0
        # a tensor divided by a tensor: a true divide on the card too
        inv = torch.ones_like(wsum) / torch.where(live, wsum, 1.0)
        out = round_u8(sums * inv[..., None])
        return torch.where(live[..., None], out, x)

    return _masked(img, by_frames(run, img), mask)
