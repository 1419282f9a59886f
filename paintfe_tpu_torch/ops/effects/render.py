"""Render effects: grid, canvas border, drop shadow and outline
(paintfe_tpu.ops.effects.render counterpart).

Behavioral contract: src/ops/effects/render.rs — grid_core (:52-92),
canvas_border_core (:114-165), shadow_core (:220-349: offset alpha ->
optional max-dilate spread -> Gaussian blur -> under-composite),
outline_core (:403-560: each pixel's distance to the nearest sample of the
opposite coverage within ceil(width) + 1, a smoothstep shell of that
distance, and the outline composited under the source (OUTSIDE), over it
(INSIDE) or both (CENTER)).

Plain torch on the image's device, byte-equal to the JAX package, except
the drop shadow's blur, which is K-blur through `filters.gaussian_blur`
(the same taps in the same order as the JAX package's `_gaussian_fn`; its
plain version on a CPU tensor).  The outline's squared distances are
integers (the squared EDT is separable, so two 1-D passes of min over
(2sr + 1) shifted copies replace the 2-D window scan), sqrts are
correctly rounded (utils/quant.sqrt_f32: torch's CPU sqrt is not) and the
divides are true divides (utils/quant.ieee_div, or a divide by a device
tensor).  Each function takes a tensor (run where it is) or a numpy image
(moved to `device`, the card unless the caller passes "cpu").
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import as_image
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.device import resolve_device
from paintfe_tpu_torch.utils.quant import ieee_div, round_u8, sqrt_f32

f32 = np.float32

# a squared distance with no sample of the wanted coverage in the window
_INF = 2 ** 30


class GridStyle(enum.IntEnum):
    LINES = 0
    CHECKERBOARD = 1


def grid(img, cell_w, cell_h, line_width, color, style=GridStyle.LINES,
         opacity=1.0, mask=None, device="cuda") -> torch.Tensor:
    """Grid lines or a checkerboard mixed over the image at `opacity`
    (render.rs:52-92)."""
    x = as_image(img, device)
    h, w = x.shape[:2]
    cw, ch, lw = max(int(cell_w), 2), max(int(cell_h), 2), max(int(line_width), 1)
    t = f32(opacity)
    xs = torch.arange(w, device=x.device)
    ys = torch.arange(h, device=x.device)
    if GridStyle(style) == GridStyle.LINES:
        draw = ((xs % cw) < lw)[None, :] | ((ys % ch) < lw)[:, None]
    else:
        draw = ((xs // cw)[None, :] + (ys // ch)[:, None]) % 2 == 0
    col_t = torch.from_numpy(np.asarray(tuple(int(c) for c in color), f32) * t).to(x.device)
    src = x.float()
    mixed = src * float(f32(1.0) - t) + col_t
    out = torch.where(draw[..., None], mixed, src)
    return _masked(x, round_u8(out), mask)


def canvas_border(img, width: int, color, mask=None, device="cuda") -> torch.Tensor:
    """Hard frame write (render.rs:114-165)."""
    x = as_image(img, device)
    h, w = x.shape[:2]
    bw = min(max(int(width), 1), min(h, w))
    xs = torch.arange(w, device=x.device)
    ys = torch.arange(h, device=x.device)
    border = ((xs < bw) | (xs >= w - bw))[None, :] | ((ys < bw) | (ys >= h - bw))[:, None]
    col = torch.from_numpy(np.asarray(color, np.uint8)).to(x.device)
    out = torch.where(border[..., None], col, x)
    return _masked(x, out, mask)


def drop_shadow(img, offset_x, offset_y, blur_radius, widen_radius, color, opacity,
                mask=None, device="cuda") -> torch.Tensor:
    """The source's alpha offset, optionally dilated by round(max(blur, 1))
    (half away from zero), blurred (K-blur, as an RGBA image [a, a, a, a]
    like the reference) and composited beneath the source in the shadow
    colour (render.rs:220-349)."""
    from paintfe_tpu_torch.ops.filters import gaussian_blur

    x = as_image(img, device)
    h, w = x.shape[:2]
    dev = x.device
    ox, oy = int(offset_x), int(offset_y)
    col = np.asarray(tuple(int(c) for c in color), f32)

    # 1. the offset alpha (0 outside the image)
    ys = np.arange(h) - oy
    xs = np.arange(w) - ox
    valid = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
    a = x[..., 3]
    shifted = a.index_select(0, torch.from_numpy(np.clip(ys, 0, h - 1)).to(dev)) \
        .index_select(1, torch.from_numpy(np.clip(xs, 0, w - 1)).to(dev))
    shadow_a = torch.where(torch.from_numpy(valid).to(dev), shifted, 0).to(torch.uint8)

    # 2. the optional spread: a separable max-dilate
    if widen_radius:
        r = int(np.floor(max(float(blur_radius), 1.0) + 0.5))
        for dim, n in ((1, w), (0, h)):
            acc = shadow_a
            for d in range(1, r + 1):
                lo = torch.from_numpy(np.clip(np.arange(n) - d, 0, n - 1)).to(dev)
                hi = torch.from_numpy(np.clip(np.arange(n) + d, 0, n - 1)).to(dev)
                acc = torch.maximum(acc, torch.maximum(shadow_a.index_select(dim, lo),
                                                       shadow_a.index_select(dim, hi)))
            shadow_a = acc

    # 3. the blur of the alpha
    if blur_radius > 0.5:
        rgba = torch.stack([shadow_a] * 4, dim=-1).contiguous()
        blurred = gaussian_blur(rgba, float(blur_radius))[..., 0]
    else:
        blurred = shadow_a

    # 4. the shadow colour composited under the source
    ca = float(col[3] / f32(255.0))
    sh_a = ieee_div(blurred.float(), 255.0) * float(f32(opacity)) * ca
    src = x.float()
    src_a = ieee_div(src[..., 3], 255.0)
    out_a = src_a + sh_a * (1.0 - src_a)
    live = out_a > 0.0
    safe = torch.where(live, out_a, 1.0)
    chans = []
    for c in range(3):
        sc = float(col[c] / f32(255.0))
        s = ieee_div(src[..., c], 255.0)
        v = torch.where(live, (s * src_a + sc * sh_a * (1.0 - src_a)) / safe, 0.0)
        chans.append(round_u8(v * 255.0))
    chans.append(round_u8(out_a * 255.0))
    return _masked(x, torch.stack(chans, dim=-1), mask)


class OutlineMode(enum.IntEnum):
    OUTSIDE = 0
    INSIDE = 1
    CENTER = 2


def _nearest_sq(hit: torch.Tensor, sr: int) -> torch.Tensor:
    """Per pixel, the least dx^2 + dy^2 over the samples of the bool plane
    `hit` within |dx|, |dy| <= sr (int32 [H, W]; _INF where there is none)."""
    h, w = hit.shape
    inf = torch.full((h, w), _INF, dtype=torch.int32, device=hit.device)
    col = inf.clone()
    for dy in range(-sr, sr + 1):  # vertical pass: nearest dy^2 in each column
        y0, y1 = max(0, -dy), min(h, h - dy)
        if y1 > y0:
            cand = torch.where(hit[y0 + dy:y1 + dy], dy * dy, _INF).to(torch.int32)
            col[y0:y1] = torch.minimum(col[y0:y1], cand)
    best = inf.clone()
    for dx in range(-sr, sr + 1):  # horizontal pass: add dx^2, reduce over columns
        x0, x1 = max(0, -dx), min(w, w - dx)
        if x1 > x0:
            best[:, x0:x1] = torch.minimum(best[:, x0:x1], col[:, x0 + dx:x1 + dx] + dx * dx)
    return torch.clamp(best, max=_INF)


def outline(img, width, color, mode=OutlineMode.OUTSIDE, anti_alias=True, mask=None,
            device="cuda") -> torch.Tensor:
    """Outline of u8 [H, W, 4] (a tensor or a numpy array) on `device`
    (the card unless the caller passes "cpu"); returns a u8 tensor there.
    Pixels the outline does not cover keep the source; masked-out pixels
    keep the input."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(img, np.uint8) if not isinstance(img, torch.Tensor)
                        else img).to(dev)
    mode = OutlineMode(mode)
    radius = f32(max(int(width), 1))
    sr = int(np.ceil(radius)) + 1
    col = np.asarray(tuple(int(c) for c in color), f32)

    def shell_coverage(distance):
        if anti_alias:
            t = torch.clamp((float(radius + f32(0.5)) - distance) / 1.0, 0.0, 1.0)
            return t * t * (3.0 - 2.0 * t)
        return torch.where(distance <= float(radius), 1.0, 0.0)

    alpha = x[..., 3]
    filled = alpha > 0
    best_fill = _nearest_sq(filled, sr)
    best_empty = _nearest_sq(~filled, sr)

    src_a = ieee_div(alpha.float(), 255.0)
    dist_fill = sqrt_f32(best_fill.float())
    dist_empty = sqrt_f32(best_empty.float())
    zero = torch.zeros_like(src_a)
    outside_cov = torch.where(best_fill < _INF,
                              shell_coverage(torch.clamp(dist_fill - 1.0, min=0.0)),
                              zero) * (1.0 - src_a)
    inside_cov = torch.where(best_empty < _INF, shell_coverage(dist_empty), zero) * src_a
    if mode == OutlineMode.OUTSIDE:
        under_cov, over_cov = outside_cov, zero
    elif mode == OutlineMode.INSIDE:
        under_cov, over_cov = zero, inside_cov
    else:
        under_cov, over_cov = outside_cov, inside_cov

    ca = float(f32(col[3] / f32(255.0)))
    a_under = ca * under_cov
    a_over = ca * over_cov
    src = x.float()
    comp = [ieee_div(src[..., c], 255.0) for c in range(3)]
    comp_a = src_a
    cc = [float(f32(col[c] / f32(255.0))) for c in range(3)]

    # under-composite (outline beneath the source)
    out_a1 = comp_a + a_under * (1.0 - comp_a)
    safe1 = torch.where(out_a1 > 0.0, out_a1, 1.0)
    do_under = (a_under > 0.0) & (out_a1 > 0.0)
    for c in range(3):
        v = (comp[c] * comp_a + cc[c] * a_under * (1.0 - comp_a)) / safe1
        comp[c] = torch.where(do_under, v, comp[c])
    comp_a = torch.where(a_under > 0.0, out_a1, comp_a)

    # over-composite (outline on top)
    out_a2 = a_over + comp_a * (1.0 - a_over)
    safe2 = torch.where(out_a2 > 0.0, out_a2, 1.0)
    do_over = (a_over > 0.0) & (out_a2 > 0.0)
    for c in range(3):
        v = (cc[c] * a_over + comp[c] * comp_a * (1.0 - a_over)) / safe2
        comp[c] = torch.where(do_over, v, comp[c])
    comp_a = torch.where(a_over > 0.0, out_a2, comp_a)

    out = torch.stack([round_u8(comp[0] * 255.0), round_u8(comp[1] * 255.0),
                       round_u8(comp[2] * 255.0), round_u8(comp_a * 255.0)], dim=-1)
    # untouched where nothing was drawn: the f32 round trip could perturb
    # those pixels, the reference writes them back as they were
    touched = (a_under > 0.0) | (a_over > 0.0)
    return _masked(x, torch.where(touched[..., None], out, x), mask)
