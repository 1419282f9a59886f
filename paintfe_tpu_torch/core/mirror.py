"""Mirror-symmetry painting + CMYK soft proof (paintfe_tpu.core.mirror
counterpart: host numpy, copied as it is).

Behavioral contract: src/canvas/mirror.rs (MirrorMode {None, Horizontal,
Vertical, Quarters}, mirrored stamp positions) and src/canvas/soft_proof.rs
(display-only RGB -> CMYK -> RGB proof).
"""

from __future__ import annotations

import enum
from typing import List, Tuple

import numpy as np

f32 = np.float32


class MirrorMode(enum.Enum):
    NONE = "none"
    HORIZONTAL = "horizontal"
    VERTICAL = "vertical"
    QUARTERS = "quarters"

    def next(self) -> "MirrorMode":
        order = [MirrorMode.NONE, MirrorMode.HORIZONTAL, MirrorMode.VERTICAL,
                 MirrorMode.QUARTERS]
        return order[(order.index(self) + 1) % 4]

    @property
    def is_active(self) -> bool:
        return self != MirrorMode.NONE

    def mirror_positions(self, x: float, y: float, w: int, h: int) -> List[Tuple[float, float]]:
        """Mirrored stamp positions; the original position comes first."""
        wf = float(w) - 1.0
        hf = float(h) - 1.0
        if self == MirrorMode.NONE:
            return [(x, y)]
        if self == MirrorMode.HORIZONTAL:
            return [(x, y), (wf - x, y)]
        if self == MirrorMode.VERTICAL:
            return [(x, y), (x, hf - y)]
        return [(x, y), (wf - x, y), (x, hf - y), (wf - x, hf - y)]


def rgb_to_cmyk(rgb: np.ndarray) -> np.ndarray:
    """RGB u8 [..., 3] -> CMYK f32 [..., 4] in [0, 1]."""
    c = 1.0 - rgb.astype(f32) / f32(255.0)
    k = c.min(axis=-1, keepdims=True)
    safe = np.maximum(1.0 - k, 1e-6)
    cmy = (c - k) / safe
    return np.concatenate([cmy, k], axis=-1).astype(f32)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    c, m, y, k = cmyk[..., 0], cmyk[..., 1], cmyk[..., 2], cmyk[..., 3]
    r = (1.0 - np.minimum(1.0, c * (1.0 - k) + k)) * 255.0
    g = (1.0 - np.minimum(1.0, m * (1.0 - k) + k)) * 255.0
    b = (1.0 - np.minimum(1.0, y * (1.0 - k) + k)) * 255.0
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5, 0, 255).astype(np.uint8)


def soft_proof_cmyk(img: np.ndarray) -> np.ndarray:
    """Display-only CMYK gamut proof (soft_proof.rs cmyk_soft_proof_pixel).

    Not a bare RGB->CMYK->RGB round trip (that reconstructs the input
    exactly); the reference's six-step pipeline is what visibly
    desaturates out-of-gamut colors: naive CMYK, Gray Component
    Replacement (ratio 0.5), 300% total-ink limit (CMY scaled first, K
    only if still over), saturation-weighted gamut compression (0.12),
    paper-white K lift (0.03), CMYK->RGB.  Alpha-0 and pure-black pixels
    pass through unchanged; rounding is half-away (floor(x+0.5), values
    are non-negative) to match Rust `.round()`.
    """
    out = np.asarray(img, np.uint8).copy()
    a = out[..., 3]
    rn = out[..., 0].astype(f32) / f32(255.0)
    gn = out[..., 1].astype(f32) / f32(255.0)
    bn = out[..., 2].astype(f32) / f32(255.0)

    max_rgb = np.maximum(np.maximum(rn, gn), bn)
    active = (a > 0) & (max_rgb > f32(0.0))
    safe_max = np.where(active, max_rgb, f32(1.0))

    # step 1: naive CMYK
    k_naive = f32(1.0) - max_rgb
    inv_k = f32(1.0) / safe_max
    c0 = (f32(1.0) - rn - k_naive) * inv_k
    m0 = (f32(1.0) - gn - k_naive) * inv_k
    y0 = (f32(1.0) - bn - k_naive) * inv_k

    # step 2: GCR — move half the common CMY component into K
    k_add = np.minimum(np.minimum(c0, m0), y0) * f32(0.5)
    cf = c0 - k_add
    mf = m0 - k_add
    yf = y0 - k_add
    kf = k_naive + k_add * (f32(1.0) - k_naive)

    # step 3: 300% total-ink limit; K (cheaper ink) is preserved unless
    # scaling CMY alone still exceeds the limit
    total = cf + mf + yf + kf
    over = total > f32(3.0)
    scale = np.where(over, f32(3.0) / np.where(over, total, f32(1.0)), f32(1.0))
    cf = cf * scale
    mf = mf * scale
    yf = yf * scale
    total2 = cf + mf + yf + kf
    over2 = total2 > f32(3.0)
    kf = np.where(over2, kf * (f32(3.0) / np.where(over2, total2, f32(1.0))), kf)

    # step 4: gamut compression for vivid bright colors
    sat = f32(1.0) - (np.minimum(np.minimum(cf, mf), yf)
                      / np.maximum(np.maximum(np.maximum(cf, mf), yf), f32(0.001)))
    compress = f32(1.0) - f32(0.12) * sat * (f32(1.0) - kf)
    cf = cf * compress
    mf = mf * compress
    yf = yf * compress

    # step 5: paper-white simulation
    kf = kf + f32(0.03) * (f32(1.0) - kf)

    # step 6: CMYK -> RGB
    one_minus_k = f32(1.0) - kf
    for ch, ink in ((0, cf), (1, mf), (2, yf)):
        v = np.clip(np.floor((f32(1.0) - ink) * one_minus_k * f32(255.0)
                             + f32(0.5)), 0, 255).astype(np.uint8)
        out[..., ch] = np.where(active, v, out[..., ch])
    return out
