"""Host-side constructors of the 256-entry LUTs of the tone-adjustment stack
(paintfe_tpu.ops.luts counterpart, host numpy).

Behavioral contract: src/ops/adjustments.rs — `build_levels_lut` (:465),
`build_curves_lut` (:639, Fritsch-Carlson monotone cubic),
`build_stretch_lut` (:236), `build_multi_channel_luts` (:584).

All math is numpy float32 scalar-for-scalar with the reference, so LUT
entries round identically.  A chain of tone ops composes by LUT
composition before touching pixels: one gather on the device applies it.

Transcendental rule (ROADMAP C2, C11): `levels_lut` raises to the power
as an f64 libm pow of the f32 base and exponent, rounded once to f32 (the
correctly rounded f32 power, as `pipeline.levels_lut`).  The JAX package
takes numpy's f32 `np.power`, whose SIMD path on AVX-512 hosts is 1 ulp
off on some inputs, so its table can differ from this one by 1 on a few
entries (ROADMAP C11).  `curves_tangents`' f32 sqrt is correctly rounded
in numpy and stays as it is.
"""

from __future__ import annotations

import math

import numpy as np

f32 = np.float32


def _round_u8(v: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(v.astype(f32) + f32(0.5)), 0, 255).astype(np.uint8)


def correct_pow(base: np.ndarray, exponent) -> np.ndarray:
    """The correctly rounded f32 power of each f32 `base` to the f32
    `exponent`: an f64 libm pow, rounded once to f32."""
    e = float(f32(exponent))
    return np.array([math.pow(float(b), e) for b in np.asarray(base, f32).ravel()],
                    f32).reshape(np.shape(base))


def identity_lut() -> np.ndarray:
    return np.arange(256, dtype=np.uint8)


def levels_lut(in_black, in_white, gamma, out_black, out_white) -> np.ndarray:
    """5-parameter levels: remap input range, gamma, map to output range."""
    in_black = f32(in_black)
    in_range = np.maximum(f32(in_white) - in_black, f32(1.0))
    out_black = f32(out_black)
    out_range = f32(out_white) - out_black
    inv_gamma = f32(1.0) / np.maximum(f32(gamma), f32(0.01))
    v = np.arange(256, dtype=f32)
    normalized = np.clip((v - in_black) / in_range, f32(0.0), f32(1.0))
    gamma_corrected = correct_pow(normalized, inv_gamma)
    output = out_black + gamma_corrected * out_range
    return _round_u8(output)


def stretch_lut(lo: int, hi: int) -> np.ndarray:
    """Auto-levels per-channel stretch: <=lo -> 0, >=hi -> 255, linear between."""
    if hi <= lo:
        return identity_lut()
    rng = f32(hi - lo)
    i = np.arange(256, dtype=f32)
    v = np.where(i <= lo, f32(0.0), np.where(i >= hi, f32(255.0), (i - f32(lo)) / rng * f32(255.0)))
    return _round_u8(v)


def curves_tangents(points):
    """Fritsch-Carlson control data: (xs, ys, m) f32 arrays, or None for
    fewer than 2 points (identity)."""
    points = [(f32(x), f32(y)) for x, y in points]
    n = len(points)
    if n < 2:
        return None

    xs = np.array([p[0] for p in points], f32)
    ys = np.array([p[1] for p in points], f32)

    delta = np.zeros(n - 1, f32)
    for i in range(n - 1):
        dx = xs[i + 1] - xs[i]
        dy = ys[i + 1] - ys[i]
        delta[i] = f32(0.0) if abs(dx) < 1e-6 else dy / dx

    m = np.zeros(n, f32)
    m[0] = delta[0]
    m[n - 1] = delta[n - 2]
    for i in range(1, n - 1):
        m[i] = f32(0.0) if delta[i - 1] * delta[i] <= 0.0 else (delta[i - 1] + delta[i]) / f32(2.0)

    for i in range(n - 1):
        if abs(delta[i]) < 1e-6:
            m[i] = f32(0.0)
            m[i + 1] = f32(0.0)
        else:
            alpha = m[i] / delta[i]
            beta = m[i + 1] / delta[i]
            s = alpha * alpha + beta * beta
            if s > 9.0:
                tau = f32(3.0) / np.sqrt(s, dtype=f32)
                m[i] = tau * alpha * delta[i]
                m[i + 1] = tau * beta * delta[i]
    return xs, ys, m


def curves_lut(points) -> np.ndarray:
    """Monotone cubic (Fritsch-Carlson) interpolation through control points.

    `points` is a sequence of (x, y) in 0..255.  Fewer than 2 points yields
    identity.
    """
    tangents = curves_tangents(points)
    if tangents is None:
        return identity_lut()
    xs, ys, m = tangents
    n = len(xs)

    lut = np.zeros(256, np.uint8)
    for i in range(256):
        x = f32(i)
        seg = 0
        for j in range(n - 1):
            if x >= xs[j]:
                seg = j
        if x <= xs[0]:
            lut[i] = _round_u8(np.array(ys[0]))
        elif x >= xs[n - 1]:
            lut[i] = _round_u8(np.array(ys[n - 1]))
        else:
            x0, x1 = xs[seg], xs[seg + 1]
            y0, y1 = ys[seg], ys[seg + 1]
            h = x1 - x0
            if abs(h) < 1e-6:
                lut[i] = _round_u8(np.array(y0))
            else:
                t = (x - x0) / h
                t2 = t * t
                t3 = t2 * t
                h00 = f32(2.0) * t3 - f32(3.0) * t2 + f32(1.0)
                h10 = t3 - f32(2.0) * t2 + t
                h01 = f32(-2.0) * t3 + f32(3.0) * t2
                h11 = t3 - t2
                val = h00 * y0 + h10 * h * m[seg] + h01 * y1 + h11 * h * m[seg + 1]
                lut[i] = _round_u8(np.array(val))
    return lut


def compose_luts(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    """(second ∘ first): apply `first` then `second`."""
    return second[first]


def multi_channel_luts(channel_points) -> np.ndarray:
    """[RGB, R, G, B, A] curve specs -> composed per-channel LUTs [4, 256].

    Each spec is (points, enabled).  RGB master is applied before R/G/B;
    alpha is independent.
    """
    ident = identity_lut()
    rgb, r, g, b, a = [
        curves_lut(pts) if enabled else ident for pts, enabled in channel_points
    ]
    return np.stack([r[rgb], g[rgb], b[rgb], a])


def levels_multi_channel_luts(master, r_ch, g_ch, b_ch) -> np.ndarray:
    """Per-channel levels on top of a master: [3, 256] composed LUTs."""
    lut_m = levels_lut(*master)
    return np.stack(
        [levels_lut(*r_ch)[lut_m], levels_lut(*g_ch)[lut_m], levels_lut(*b_ch)[lut_m]]
    )


def gradient_map_lut(stops) -> np.ndarray:
    """Build a 256x4 RGBA LUT by linear interpolation between color stops.

    `stops`: sequence of (t in [0,1], (r, g, b, a)).
    """
    stops = sorted(stops, key=lambda s: s[0])
    lut = np.zeros((256, 4), np.uint8)
    if not stops:
        return lut  # reference rebuild_lut fills zeros (state.rs:1066-1070)
    ts = np.array([s[0] for s in stops], f32)
    cols = np.array([s[1] for s in stops], f32)
    for i in range(256):
        t = i / f32(255.0)
        if t <= ts[0]:
            c = cols[0]
        elif t >= ts[-1]:
            c = cols[-1]
        else:
            # FIRST matching segment like the reference's linear scan
            # (searchsorted side='right' picked the last coincident stop
            # at duplicated positions)
            j = int(np.searchsorted(ts, t, side="left"))
            if ts[j] > t:
                j -= 1
            span = ts[j + 1] - ts[j]
            frac = f32(0.0) if span <= 0 else (t - ts[j]) / span
            c = cols[j] * (f32(1.0) - frac) + cols[j + 1] * frac
        lut[i] = _round_u8(c)
    return lut
