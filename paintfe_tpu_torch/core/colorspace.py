"""Colour-space conversions (paintfe_tpu.core.colorspace counterpart), on
torch tensors and on numpy arrays.

Behavioral contract: src/ops/adjustments.rs:944-1022 (rgb_to_hsl /
hsl_to_rgb / hue_to_rgb) — including the 1e-6 epsilon branch conditions and
the max-channel tie-break order (R, then G, then B), which affect golden
parity for HSL-family adjustments.

Each function takes f32 torch tensors (on any device) or f32 numpy arrays
and returns the same kind.  On tensors a divide by a constant is
`ieee_div` (a true divide on the card too); a divide by a tensor is
already one.  The numpy path is the JAX package's host path as it is
(selection.select_color_range uses it).
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.utils.quant import ieee_div

_EPS = 1e-6


def _xp(x):
    """The array module of x: torch for tensors (torch.where takes scalars),
    numpy otherwise."""
    return torch if isinstance(x, torch.Tensor) else np


def rgb_to_hsl(r, g, b):
    """RGB in [0,1] -> (h, s, l) each in [0,1], on tensors or numpy."""
    xp = _xp(r)
    # a divide by an array is a true divide on every device; one by a
    # constant is ieee_div on tensors
    div_c = ieee_div if xp is torch else (lambda x, c: x / np.float32(c))
    div_hw = lambda x, c: x / c  # noqa: E731
    mx = xp.maximum(xp.maximum(r, g), b)
    mn = xp.minimum(xp.minimum(r, g), b)
    l = (mx + mn) / 2.0
    d = mx - mn
    gray = xp.abs(d) < _EPS
    safe_d = xp.where(gray, 1.0, d)

    s_hi = div_hw(d, xp.where(gray, 1.0, 2.0 - mx - mn))
    s_lo = div_hw(d, xp.where(gray, 1.0, mx + mn))
    s = xp.where(gray, 0.0, xp.where(l > 0.5, s_hi, s_lo))

    # Hue: branch order matches the reference (R first, then G, else B).
    hr_raw = div_hw(g - b, safe_d)
    hr = div_c(xp.where(hr_raw < 0.0, hr_raw + 6.0, hr_raw), 6.0)
    hg = div_c(div_hw(b - r, safe_d) + 2.0, 6.0)
    hb = div_c(div_hw(r - g, safe_d) + 4.0, 6.0)
    h = xp.where(
        xp.abs(mx - r) < _EPS, hr, xp.where(xp.abs(mx - g) < _EPS, hg, hb)
    )
    h = xp.where(gray, 0.0, h)
    return h, s, l


def _hue_to_rgb(p, q, t):
    xp = _xp(t)
    t = xp.where(t < 0.0, t + 1.0, t)
    t = xp.where(t > 1.0, t - 1.0, t)
    return xp.where(
        t < 1.0 / 6.0,
        p + (q - p) * 6.0 * t,
        xp.where(
            t < 1.0 / 2.0,
            q,
            xp.where(t < 2.0 / 3.0, p + (q - p) * (2.0 / 3.0 - t) * 6.0, p),
        ),
    )


def hsl_to_rgb(h, s, l):
    """HSL in [0,1] -> (r, g, b) in [0,1], on tensors or numpy."""
    xp = _xp(l)
    q = xp.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    p = 2.0 * l - q
    r = _hue_to_rgb(p, q, h + 1.0 / 3.0)
    g = _hue_to_rgb(p, q, h)
    b = _hue_to_rgb(p, q, h - 1.0 / 3.0)
    gray = xp.abs(s) < _EPS
    return (
        xp.where(gray, l, r),
        xp.where(gray, l, g),
        xp.where(gray, l, b),
    )


def luma_bt709(r, g, b):
    """BT.709 luminance on 0..255-scaled f32 channels (order-preserving
    sum; each coefficient rounds to f32 against an f32 tensor)."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def luma_bt601_int(r_u8, g_u8, b_u8):
    """Integer BT.601 luma (299r+587g+114b)/1000 — the script-API
    desaturate — of u8 tensors or arrays."""
    if isinstance(r_u8, torch.Tensor):
        acc = r_u8.int() * 299 + g_u8.int() * 587 + b_u8.int() * 114
        return torch.div(acc, 1000, rounding_mode="floor").to(torch.uint8)
    acc = (r_u8.astype(np.uint32) * 299 + g_u8.astype(np.uint32) * 587
           + b_u8.astype(np.uint32) * 114)
    return (acc // 1000).astype(np.uint8)
