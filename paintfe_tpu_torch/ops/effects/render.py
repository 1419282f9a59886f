"""Render effects: the outline (paintfe_tpu.ops.effects.render counterpart,
`OutlineMode` and `outline`; its grid, canvas border and drop shadow wait
for ROADMAP A6).

Behavioral contract: src/ops/effects/render.rs outline_core (:403-560):
each pixel's distance to the nearest sample of the opposite coverage
within ceil(width) + 1, a smoothstep shell of that distance, and the
outline composited under the source (OUTSIDE), over it (INSIDE) or both
(CENTER).

Plain torch on the image's device, byte-equal to the JAX package: the
squared distances are integers (the squared EDT is separable, so two 1-D
passes of min over (2sr + 1) shifted copies replace the 2-D window scan),
the sqrt is correctly rounded (utils/quant.sqrt_f32: torch's CPU sqrt is
not) and the divides are true divides (utils/quant.ieee_div).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.device import resolve_device
from paintfe_tpu_torch.utils.quant import ieee_div, round_u8, sqrt_f32

f32 = np.float32

# a squared distance with no sample of the wanted coverage in the window
_INF = 2 ** 30


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
