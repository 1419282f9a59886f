"""Selection system: shapes, combine modes, mask ops, color-range select
(paintfe_tpu.core.selection counterpart: host numpy, copied as it is, so
the same host gives the same bytes).

Behavioral contract: src/canvas/selection.rs (SelectionMode, rect/ellipse
containment) and src/ops/adjustments.rs:1448-1792 (feather = repeated
separable box blur with integer mean, expand/contract = disc dilate/erode,
select_color_range = HSL hue-wheel proximity with fuzziness and
Replace/Add/Subtract/Intersect merging).

Masks are numpy u8 [H, W]; None = everything selected.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

f32 = np.float32


class SelectionMode(enum.Enum):
    REPLACE = "replace"
    ADD = "add"
    SUBTRACT = "subtract"
    INTERSECT = "intersect"


def rect_mask(w: int, h: int, min_x: int, min_y: int, max_x: int, max_y: int) -> np.ndarray:
    """Inclusive-bounds rectangle (selection.rs:66-82)."""
    mask = np.zeros((h, w), np.uint8)
    x0 = max(min_x, 0)
    y0 = max(min_y, 0)
    x1 = min(max_x, w - 1)
    y1 = min(max_y, h - 1)
    if x1 >= x0 and y1 >= y0:
        mask[y0 : y1 + 1, x0 : x1 + 1] = 255
    return mask


def ellipse_mask(w: int, h: int, cx: float, cy: float, rx: float, ry: float) -> np.ndarray:
    """Normalized-radius containment (selection.rs:84-92)."""
    if rx <= 0.0 or ry <= 0.0:
        return np.zeros((h, w), np.uint8)
    xs = (np.arange(w, dtype=f32) - f32(cx)) / f32(rx)
    ys = (np.arange(h, dtype=f32) - f32(cy)) / f32(ry)
    inside = xs[None, :] ** 2 + ys[:, None] ** 2 <= 1.0
    return np.where(inside, 255, 0).astype(np.uint8)


def combine(base: Optional[np.ndarray], new: np.ndarray, mode: SelectionMode,
            w: int, h: int) -> Optional[np.ndarray]:
    """Merge a new shape mask into the existing selection."""
    mode = SelectionMode(mode)
    if mode == SelectionMode.REPLACE:
        return new
    if base is None:
        base = np.zeros((h, w), np.uint8)
    if mode == SelectionMode.ADD:
        return np.maximum(base, new)
    if mode == SelectionMode.SUBTRACT:
        return np.maximum(base.astype(np.int16) - new.astype(np.int16), 0).astype(np.uint8)
    # INTERSECT: a*b/255 integer
    return (base.astype(np.uint16) * new.astype(np.uint16) // 255).astype(np.uint8)


def translate(mask: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Shift the mask, clipping at the edges (unselected fills in)."""
    h, w = mask.shape
    out = np.zeros_like(mask)
    sx0, dx0 = (0, dx) if dx >= 0 else (-dx, 0)
    sy0, dy0 = (0, dy) if dy >= 0 else (-dy, 0)
    cw = w - abs(dx)
    ch = h - abs(dy)
    if cw > 0 and ch > 0:
        out[dy0 : dy0 + ch, dx0 : dx0 + cw] = mask[sy0 : sy0 + ch, sx0 : sx0 + cw]
    return out


def feather(mask: np.ndarray, radius: float) -> np.ndarray:
    """Repeated separable box blur, integer mean with edge-clamped windows
    (adjustments.rs:1448-1499)."""
    h, w = mask.shape
    passes = max(int(radius / 2.0), 1)
    r = max(int(radius), 1)
    data = mask.astype(np.uint32)

    def axis_pass(d, axis):
        # edge-clamped sliding-window integer mean via cumulative sums
        csum = np.cumsum(d, axis=axis)
        n = d.shape[axis]
        idx_hi = np.minimum(np.arange(n) + r, n - 1)
        idx_lo = np.arange(n) - r - 1
        hi = np.take(csum, idx_hi, axis=axis)
        lo_clipped = np.take(csum, np.maximum(idx_lo, 0), axis=axis)
        shape = (slice(None), None) if axis == 0 else (None, slice(None))
        lo_valid = (idx_lo >= 0)[shape]
        lo = np.where(lo_valid, lo_clipped, 0)
        counts = (idx_hi - np.maximum(np.arange(n) - r, 0) + 1)[shape]
        return (hi - lo) // counts

    for _ in range(passes):
        data = axis_pass(data, axis=1)
        data = axis_pass(data, axis=0)
    return data.astype(np.uint8)


def _disc_hits(mask_bool: np.ndarray, r: int) -> np.ndarray:
    """True where any selected pixel lies within disc radius r."""
    h, w = mask_bool.shape
    out = np.zeros_like(mask_bool)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy > r * r:
                continue
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            out[yd, xd] |= mask_bool[ys, xs]
    return out


def expand(mask: np.ndarray, radius: int) -> np.ndarray:
    """Disc dilate: unselected pixels with a selected pixel within `radius`
    become 255 (adjustments.rs:1500-1546)."""
    r = max(int(radius), 0)
    sel = mask > 127
    grown = _disc_hits(sel, r)
    out = mask.copy()
    out[(~sel) & grown] = 255
    return out


def contract(mask: np.ndarray, radius: int) -> np.ndarray:
    """Disc erode (adjustments.rs:1546-1586): any NONZERO pixel with a
    fully-ZERO pixel within `radius` becomes 0.  Note the asymmetry with
    expand (which thresholds at >127): contract erodes feathered 1-127
    values too, and a partial value never counts as 'unselected'."""
    r = max(int(radius), 0)
    nonzero = mask != 0
    near_zero = _disc_hits(mask == 0, r)
    out = mask.copy()
    out[nonzero & near_zero] = 0
    return out


def select_color_range(pixels: np.ndarray, hue_center_deg: float,
                       hue_tolerance_deg: float, sat_min: float,
                       fuzziness: float, base: Optional[np.ndarray] = None,
                       mode: SelectionMode = SelectionMode.REPLACE) -> np.ndarray:
    """HSL-proximity selection (adjustments.rs:1684-1792).

    The hue/saturation math is the shared rgb_to_hsl (host-numpy flavor):
    the epsilon branches and R/G/B tie-break order are the documented
    parity minefield and must not fork from the HSL-family adjustments."""
    from paintfe_tpu_torch.core.colorspace import rgb_to_hsl

    h, w = pixels.shape[:2]
    r = pixels[..., 0].astype(f32) / f32(255.0)
    g = pixels[..., 1].astype(f32) / f32(255.0)
    b = pixels[..., 2].astype(f32) / f32(255.0)
    hue, s, _l = rgb_to_hsl(r, g, b)

    hue_center = f32(hue_center_deg) / f32(360.0)
    hue_tol = max(f32(hue_tolerance_deg) / f32(360.0), f32(0.001))
    fuzz = f32(np.clip(fuzziness, 0.001, 1.0))

    diff = np.abs(hue - hue_center)
    diff = np.where(diff > 0.5, f32(1.0) - diff, diff)
    weight = 1.0 - np.power(diff / hue_tol, f32(1.0) / max(fuzz, f32(0.01)), dtype=f32)
    alpha = np.clip(weight * 255.0, 0.0, 255.0).astype(np.uint8)
    selected = (pixels[..., 3] > 0) & (s >= sat_min) & (diff <= hue_tol)
    new_mask = np.where(selected, alpha, 0).astype(np.uint8)
    return combine(base, new_mask, mode, w, h)


def fill_selected(pixels: np.ndarray, mask: Optional[np.ndarray], color) -> np.ndarray:
    """Fill with proportional blending on partial mask values
    (canvas_state_impl.rs:1544-1578): sel==255 replaces outright, 1-254
    blends old*(1-t) + new*t per channel (t = sel/255, round-half-away) —
    feathered selections get soft-edged fills."""
    out = pixels.copy()
    color = np.asarray(color, np.uint8)
    if mask is None:
        out[...] = color
        return out
    sel = np.asarray(mask)
    full = sel == 255
    out[full] = color
    partial = (sel > 0) & ~full
    if partial.any():
        t = sel.astype(f32)[..., None] / f32(255.0)
        blended = np.floor(pixels.astype(f32) * (f32(1.0) - t)
                           + color.astype(f32)[None, None, :] * t
                           + f32(0.5)).astype(np.uint8)
        out = np.where(partial[..., None], blended, out)
    return out


def delete_selected(pixels: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """Delete keeps RGB and scales only ALPHA on partial mask values
    (canvas_state_impl.rs:1515-1540): sel==255 clears to (0,0,0,0), 1-254
    multiplies alpha by (1 - sel/255) — a feathered cut leaves a soft
    edge, not a hard hole."""
    out = pixels.copy()
    if mask is None:
        out[...] = 0
        return out
    sel = np.asarray(mask)
    full = sel == 255
    out[full] = 0
    partial = (sel > 0) & ~full
    if partial.any():
        factor = f32(1.0) - sel.astype(f32) / f32(255.0)
        new_a = np.floor(pixels[..., 3].astype(f32) * factor
                         + f32(0.5)).astype(np.uint8)
        out[..., 3] = np.where(partial, new_a, out[..., 3])
    return out
