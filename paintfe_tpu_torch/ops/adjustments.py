"""Pointwise colour adjustments, the adjustment stack
(paintfe_tpu.ops.adjustments counterpart).

Behavioral contract: src/ops/adjustments.rs.  Every op is a function
`(img_u8 [H, W, 4], params..., mask=None, device="cuda") -> u8 tensor`
with the reference's semantics: f32 math on 0..255-scaled channels,
round-half-up clamp to u8, masked-out pixels (mask == 0) copied through
unchanged.  A tensor runs where it is; a numpy image goes to `device`,
the card unless the caller passes "cpu".

Plain torch in the JAX package's f32 expression order, one op a torch
call, so nothing contracts into an FMA: byte-equal to the JAX package.
Divides by a constant are true divides (`ieee_div`), divides by a
per-image value divide by a device tensor (a divide by a host scalar is a
multiply by its reciprocal on the card).  Scalar parameters are folded on
the host in numpy f32, as XLA folds them.  The tone ops are table gathers
(the JAX package's CPU branch): `levels`, `levels_direct`,
`levels_per_channel`, `curves` and `gradient_map_stops` build their
256-entry tables with `ops/luts` on the host, and the JAX package's
per-pixel evaluations for the TPU equal those tables on u8 inputs, but
one: its per-pixel curves group a product differently from its curves
table and differ from it on some inputs (ROADMAP C12), so `curves_direct`
gathers from a table of the per-pixel math (`curves_direct_luts`),
byte-equal to the JAX `curves_direct`.

Transcendental rule (ROADMAP C2): no transcendental runs per pixel.
`exposure`'s 2^ev is one host scalar (`pipeline.exposure_gain`, an f64
pow of the f32 ev rounded once, ROADMAP C6); the levels power is the
host table of `luts.levels_lut` (an f64 pow rounded once; ROADMAP C11 for
the JAX package's numpy-power table).  The HSL ops take the colorspace
pair of `core/colorspace`, which is IEEE-basic.
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.core.colorspace import hsl_to_rgb, luma_bt709, rgb_to_hsl
from paintfe_tpu_torch.ops import luts
from paintfe_tpu_torch.ops.common import as_image
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.quant import ieee_div, round_u8

f32 = np.float32


def _pointwise(img, mask, fn, device):
    x = as_image(img, device)
    f = x.float()
    nr, ng, nb, na = fn(f[..., 0], f[..., 1], f[..., 2], f[..., 3])
    out = round_u8(torch.stack([nr, ng, nb, na], dim=-1))
    return _masked(x, out, mask)


def _hsl(r, g, b):
    return rgb_to_hsl(ieee_div(r, 255.0), ieee_div(g, 255.0), ieee_div(b, 255.0))


# ---------------------------------------------------------------------------
# Instant ops
# ---------------------------------------------------------------------------


def invert_colors(img, mask=None, device="cuda"):
    return _pointwise(img, mask, lambda r, g, b, a: (255.0 - r, 255.0 - g, 255.0 - b, a),
                      device)


def invert_alpha(img, mask=None, device="cuda"):
    return _pointwise(img, mask, lambda r, g, b, a: (r, g, b, 255.0 - a), device)


def sepia(img, mask=None, device="cuda"):
    def fn(r, g, b, a):
        sr = 0.393 * r + 0.769 * g + 0.189 * b
        sg = 0.349 * r + 0.686 * g + 0.168 * b
        sb = 0.272 * r + 0.534 * g + 0.131 * b
        return (torch.clamp(sr, max=255.0), torch.clamp(sg, max=255.0),
                torch.clamp(sb, max=255.0), a)

    return _pointwise(img, mask, fn, device)


def desaturate(img, mask=None, device="cuda"):
    """Menu desaturate: BT.709 weights (filters.rs:319-378)."""

    def fn(r, g, b, a):
        lum = torch.clamp(torch.floor(luma_bt709(r, g, b) + 0.5), 0.0, 255.0)
        return lum, lum, lum, a

    return _pointwise(img, mask, fn, device)


def desaturate_bt601(img, mask=None, device="cuda"):
    """Script-API desaturate: integer BT.601 (scripting.rs:883-897)."""
    x = as_image(img, device)
    p = x.int()
    lum = torch.div(p[..., 0] * 299 + p[..., 1] * 587 + p[..., 2] * 114, 1000,
                    rounding_mode="floor").to(torch.uint8)
    return _masked(x, torch.stack([lum, lum, lum, x[..., 3]], dim=-1), mask)


def auto_levels(img, mask=None, device="cuda"):
    """Stretch each channel's [min, max] (over selected, non-transparent
    pixels) to [0, 255] (adjustments.rs:144-256).  The range is a device
    tensor, so the divide is a true divide on the card too."""
    x = as_image(img, device)
    opaque = x[..., 3] > 0
    if mask is not None:
        opaque = opaque & (torch.as_tensor(mask, device=x.device) > 0)

    def stretch(c):
        lo = torch.where(opaque, c, 255).amin().int()
        hi = torch.where(opaque, c, 0).amax().int()
        i = c.float()
        lof, hif = lo.float(), hi.float()
        stretched = (i - lof) / (hif - lof) * 255.0
        v = torch.where(i <= lof, 0.0, torch.where(i >= hif, 255.0, stretched))
        return torch.where(hi <= lo, c, round_u8(v))

    out = torch.stack([stretch(x[..., 0]), stretch(x[..., 1]), stretch(x[..., 2]),
                       x[..., 3]], dim=-1)
    return _masked(x, out, mask)


# ---------------------------------------------------------------------------
# Parameterized ops
# ---------------------------------------------------------------------------


def brightness_contrast(img, brightness, contrast, mask=None, device="cuda"):
    """factor = 259(c+255) / (255(259-c)); out = factor*(v+b-128)+128."""
    c = f32(contrast)
    factor = float((f32(259.0) * (c + f32(255.0))) / (f32(255.0) * (f32(259.0) - c)))
    b = float(f32(brightness))

    def fn(r, g, bl, a):
        def adj(v):
            return factor * (v + b - 128.0) + 128.0
        return adj(r), adj(g), adj(bl), a

    return _pointwise(img, mask, fn, device)


def hue_saturation_lightness(img, hue_shift, saturation, lightness, mask=None,
                             device="cuda"):
    sat_factor = float(f32(1.0) + f32(saturation) / f32(100.0))
    light_offset = float(f32(lightness) * f32(255.0) / f32(100.0))
    shift = float(f32(hue_shift) / f32(360.0))

    def fn(r, g, b, a):
        h, s, l = _hsl(r, g, b)
        nh = h + shift
        nh = nh - torch.trunc(nh)  # Rust fract()
        nh = torch.where(nh < 0.0, nh + 1.0, nh)
        ns = torch.clamp(s * sat_factor, 0.0, 1.0)
        nr, ng, nb = hsl_to_rgb(nh, ns, l)
        return (nr * 255.0 + light_offset, ng * 255.0 + light_offset,
                nb * 255.0 + light_offset, a)

    return _pointwise(img, mask, fn, device)


def exposure(img, ev, mask=None, device="cuda"):
    """Multiply RGB by 2^ev: the gain is one host scalar, correctly rounded
    (pipeline.exposure_gain; ROADMAP C6)."""
    from paintfe_tpu_torch.parallel.pipeline import exposure_gain

    gain = float(exposure_gain(ev))
    return _pointwise(img, mask, lambda r, g, b, a: (r * gain, g * gain, b * gain, a),
                      device)


def highlights_shadows(img, shadows, highlights, mask=None, device="cuda"):
    shadow_amt = float(f32(shadows) / f32(100.0))
    highlight_amt = float(f32(highlights) / f32(100.0))

    def fn(r, g, b, a):
        lum = ieee_div(luma_bt709(r, g, b), 255.0)
        sw = (1.0 - lum) * (1.0 - lum)
        hw = lum * lum
        adj = sw * shadow_amt * 128.0 + hw * highlight_amt * 128.0
        return r + adj, g + adj, b + adj, a

    return _pointwise(img, mask, fn, device)


def temperature_tint(img, temperature, tint, mask=None, device="cuda"):
    temp_shift = float(f32(temperature) * f32(1.5))
    tint_half = float(f32(f32(tint) * f32(1.0)) * f32(0.5))
    return _pointwise(img, mask, lambda r, g, b, a: (r + temp_shift, g - tint_half,
                                                     b - temp_shift, a), device)


def threshold(img, level, mask=None, device="cuda"):
    lv = float(f32(level))

    def fn(r, g, b, a):
        v = torch.where(luma_bt709(r, g, b) >= lv, 255.0, 0.0)
        return v, v, v, a

    return _pointwise(img, mask, fn, device)


def posterize(img, levels_count, mask=None, device="cuda"):
    steps = float(np.maximum(f32(levels_count), f32(2.0)) - f32(1.0))

    def p(v):
        return ieee_div(torch.floor(ieee_div(v, 255.0) * steps + 0.5), steps) * 255.0

    return _pointwise(img, mask, lambda r, g, b, a: (p(r), p(g), p(b), a), device)


def color_balance(img, shadows, midtones, highlights, mask=None, device="cuda"):
    """Per-tonal-band RGB shifts; band weights from luma (adjustments.rs:1319-1337)."""
    sh = [float(v) for v in np.asarray(shadows, f32)]
    mid = [float(v) for v in np.asarray(midtones, f32)]
    hi = [float(v) for v in np.asarray(highlights, f32)]

    def fn(r, g, b, a):
        lum = ieee_div(luma_bt709(r, g, b), 255.0)
        t = torch.clamp(1.0 - lum * 2.0, min=0.0)
        sw = t * t
        t = torch.clamp(lum * 2.0 - 1.0, min=0.0)
        hw = t * t
        mw = torch.clamp(1.0 - sw - hw, min=0.0)

        def adj(i):
            return sw * sh[i] + mw * mid[i] + hw * hi[i]

        return r + adj(0) * 1.28, g + adj(1) * 1.28, b + adj(2) * 1.28, a

    return _pointwise(img, mask, fn, device)


def gradient_map(img, lut_rgba, mask=None, device="cuda"):
    """Truncated BT.709 luma indexes a 256xRGBA LUT; alpha preserved."""
    x = as_image(img, device)
    f = x.float()
    idx = torch.clamp(luma_bt709(f[..., 0], f[..., 1], f[..., 2]).int(), max=255)
    table = torch.from_numpy(np.ascontiguousarray(lut_rgba, np.uint8)).to(x.device)
    out = torch.cat([table[idx.long()][..., 0:3], x[..., 3:4]], dim=-1)
    return _masked(x, out, mask)


def gradient_map_stops(img, stops, mask=None, device="cuda"):
    """Gradient map from colour stops: the table of luts.gradient_map_lut
    at the truncated luma (the JAX package's CPU branch; its TPU branch
    evaluates the same stops per pixel, bit-identically on u8 inputs)."""
    return gradient_map(img, luts.gradient_map_lut(stops), mask, device)


def black_and_white(img, r_weight, g_weight, b_weight, mask=None, device="cuda"):
    rw, gw, bw = float(f32(r_weight)), float(f32(g_weight)), float(f32(b_weight))

    def fn(r, g, b, a):
        v = torch.clamp(ieee_div(r * rw + g * gw + b * bw, 100.0), 0.0, 255.0)
        return v, v, v, a

    return _pointwise(img, mask, fn, device)


def vibrance(img, amount, mask=None, device="cuda"):
    v = f32(amount) / f32(100.0)
    vf = float(v)

    def fn(r, g, b, a):
        h, s, l = _hsl(r, g, b)
        t = 1.0 - s if v >= 0.0 else s
        boost = vf * (t * t)
        ns = torch.clamp(s + boost, 0.0, 1.0)
        nr, ng, nb = hsl_to_rgb(h, ns, l)
        return nr * 255.0, ng * 255.0, nb * 255.0, a

    return _pointwise(img, mask, fn, device)


# ---------------------------------------------------------------------------
# LUT application (levels / curves tables built in ops/luts)
# ---------------------------------------------------------------------------


def _table(lut, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(lut, np.uint8)).to(dev)


def apply_rgb_lut(img, lut, mask=None, device="cuda"):
    """One u8 LUT on R, G and B; alpha untouched."""
    x = as_image(img, device)
    table = _table(lut, x.device)
    out = torch.cat([table[x[..., 0:3].long()], x[..., 3:4]], dim=-1)
    return _masked(x, out, mask)


def apply_rgba_luts(img, luts4, mask=None, device="cuda"):
    """Independent per-channel LUTs [4, 256] (curves multi-channel)."""
    x = as_image(img, device)
    table = _table(luts4, x.device)
    out = torch.stack([table[c][x[..., c].long()] for c in range(4)], dim=-1)
    return _masked(x, out, mask)


def levels(img, in_black, in_white, gamma, out_black, out_white, mask=None,
           device="cuda"):
    """5-parameter levels (adjustments.rs:424-489): the gather of
    luts.levels_lut (its power correctly rounded, ROADMAP C11)."""
    lut = luts.levels_lut(in_black, in_white, gamma, out_black, out_white)
    return apply_rgb_lut(img, lut, mask, device)


def levels_direct(img, in_black, in_white, gamma, out_black, out_white, mask=None,
                  device="cuda"):
    """The JAX package's per-pixel levels (jnp.power of u8 inputs): here the
    same host table as `levels`, which equals it on every u8 input."""
    return levels(img, in_black, in_white, gamma, out_black, out_white, mask, device)


def curves(img, channel_points, mask=None, device="cuda"):
    """Multi-channel curves [RGB, R, G, B, A] of (points, enabled): the
    per-channel tables of luts.multi_channel_luts."""
    return apply_rgba_luts(img, luts.multi_channel_luts(channel_points), mask, device)


def curve_direct_values(v: np.ndarray, tangents) -> np.ndarray:
    """The JAX package's per-pixel Fritsch-Carlson evaluation
    (`_curve_eval`) of f32 values `v`, in its f32 order on the host.  It
    groups h * m[seg] ahead of the Hermite basis, where luts.curves_lut
    multiplies (h10 * h) * m[seg], so on some u8 inputs the two round to
    different u8 (ROADMAP C12)."""
    if tangents is None:
        return v
    xs, ys, m = tangents
    out = np.full_like(v, f32(ys[0]))
    for seg in range(len(xs) - 1):
        x0, x1 = f32(xs[seg]), f32(xs[seg + 1])
        y0, y1 = f32(ys[seg]), f32(ys[seg + 1])
        h = f32(x1 - x0)
        if abs(float(h)) < 1e-6:
            val = np.full_like(v, y0)
        else:
            t = (v - x0) / h
            t2 = t * t
            t3 = t2 * t
            h00 = f32(2.0) * t3 - f32(3.0) * t2 + f32(1.0)
            h10 = t3 - f32(2.0) * t2 + t
            h01 = f32(-2.0) * t3 + f32(3.0) * t2
            h11 = t3 - t2
            val = (h00 * y0 + h10 * (h * f32(m[seg]))
                   + h01 * y1 + h11 * (h * f32(m[seg + 1])))
        # the curves table takes the last segment with x >= xs[seg]
        out = np.where(v >= x0, val, out)
    out = np.where(v <= f32(xs[0]), f32(ys[0]), out)
    return np.where(v >= f32(xs[-1]), f32(ys[-1]), out).astype(f32)


def curves_direct_luts(channel_points) -> np.ndarray:
    """[4, 256] u8 tables of the JAX package's per-pixel curves
    (`_curves_direct_fn`): the RGB curve, quantized to u8, then the
    channel's curve, quantized; alpha takes its own curve only.  Its inputs
    are u8, so a table of its math on the 256 values is exact."""
    prepared = [luts.curves_tangents(pts) if en and pts else None
                for pts, en in channel_points]
    prepared += [None] * (5 - len(prepared))
    rgb_t = prepared[0]

    def quantize(v, t):
        if t is None:
            return v
        return np.clip(np.floor(curve_direct_values(v, t) + f32(0.5)), 0.0, 255.0).astype(f32)

    v = np.arange(256, dtype=f32)
    rows = [quantize(quantize(v, rgb_t) if c < 3 else v, prepared[c + 1]) for c in range(4)]
    return np.stack(rows).astype(np.uint8)


def curves_direct(img, channel_points, mask=None, device="cuda"):
    """The JAX package's per-pixel multi-channel curves, as a gather of
    curves_direct_luts (byte-equal to it on every u8 input)."""
    return apply_rgba_luts(img, curves_direct_luts(channel_points), mask, device)


def levels_per_channel(img, master, r_ch, g_ch, b_ch, mask=None, device="cuda"):
    """Master + per-channel composed levels: the tables of
    luts.levels_multi_channel_luts, alpha untouched."""
    lut3 = luts.levels_multi_channel_luts(master, r_ch, g_ch, b_ch)
    luts4 = np.concatenate([lut3, luts.identity_lut()[None]], axis=0)
    return apply_rgba_luts(img, luts4, mask, device)


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------


def histogram(img, mask=None, device="cuda") -> torch.Tensor:
    """Per-channel 256-bin histograms + BT.709 luma histogram -> [4, 256]
    int32, counting the selected pixels only."""
    x = as_image(img, device)
    if mask is None:
        sel = torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)
    else:
        sel = (torch.as_tensor(mask, device=x.device) > 0).int()
    sel = sel.reshape(-1)

    def hist_of(v):
        out = torch.zeros(256, dtype=torch.int32, device=x.device)
        return out.index_add_(0, v.reshape(-1).long(), sel)

    f = x.float()
    lum = torch.clamp(luma_bt709(f[..., 0], f[..., 1], f[..., 2]).int(), max=255)
    return torch.stack([hist_of(x[..., 0]), hist_of(x[..., 1]), hist_of(x[..., 2]),
                        hist_of(lum)])


# ---------------------------------------------------------------------------
# Per-hue-band HSL (adjustments.rs:1599-1674)
# ---------------------------------------------------------------------------

BAND_CENTERS = (0.0, 60.0, 120.0, 180.0, 240.0, 300.0)  # R, Y, G, C, B, M


def _band_weight(hue_deg, center):
    """Full weight within +-30 deg, linear falloff to 0 at +-45 deg.  The
    remainder is torch.remainder, the floor-mod of Python's % and of
    jnp.remainder."""
    dist = torch.remainder(torch.abs(hue_deg - center), 360.0)
    dist = torch.where(dist > 180.0, 360.0 - dist, dist)
    return torch.where(dist <= 30.0, 1.0,
                       torch.where(dist < 45.0, 1.0 - ieee_div(dist - 30.0, 15.0), 0.0))


def hue_saturation_per_band(img, global_hue, global_sat, global_light, band_hues,
                            band_sats, band_lights, mask=None, device="cuda"):
    """Global HSL plus six weighted hue-band adjustments.

    band_* are [6] sequences (hue -180..180, sat -100..100, light
    -100..100); band contributions accumulate on top of the global values
    weighted by hue-wheel proximity."""
    g_sat = float(f32(1.0) + f32(global_sat) / f32(100.0))
    g_light = float(f32(global_light) * f32(255.0) / f32(100.0))
    g_hue = float(f32(global_hue))
    hues = np.asarray(band_hues, f32)
    sats = np.asarray(band_sats, f32) / f32(100.0)
    lights = np.asarray(band_lights, f32) * f32(255.0) / f32(100.0)

    def fn(r, g, b, a):
        h, s, l = _hsl(r, g, b)
        h_deg = h * 360.0
        extra_hue = extra_sat = extra_light = None
        for i, center in enumerate(BAND_CENTERS):
            w = _band_weight(h_deg, center)
            extra_hue = (g_hue if extra_hue is None else extra_hue) + float(hues[i]) * w
            extra_sat = (g_sat if extra_sat is None else extra_sat) + float(sats[i]) * w
            extra_light = (g_light if extra_light is None else extra_light) \
                + float(lights[i]) * w
        nh = torch.remainder(torch.remainder(h + ieee_div(extra_hue, 360.0), 1.0) + 1.0,
                             1.0)
        ns = torch.clamp(s * extra_sat, 0.0, 1.0)
        nr, ng, nb = hsl_to_rgb(nh, ns, l)
        return (nr * 255.0 + extra_light, ng * 255.0 + extra_light,
                nb * 255.0 + extra_light, a)

    return _pointwise(img, mask, fn, device)
