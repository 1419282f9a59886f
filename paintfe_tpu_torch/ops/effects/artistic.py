"""Artistic effects: ink (Sobel), oil painting (modal intensity bin) and
the colour filter (paintfe_tpu.ops.effects.artistic counterpart).

Behavioral contract: src/ops/effects/artistic.rs — ink_core (:31-101),
oil_painting_core (:123-218), color_filter_core (:218-310).  All are
IEEE-basic and byte-equal to the JAX package: ink's Sobel sums run in f32
in the reference's expression order with a correctly rounded sqrt and
divide; oil painting is integer window sums per intensity level, the
modal level taken with a strict > (the first maximum wins, the
reference's tie order); the colour filter's blends run in f32 in the JAX
package's order, soft light's sqrt correctly rounded (`sqrt_f32`: torch's
CPU sqrt is 1 ulp low on some inputs, ROADMAP C1).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import as_image, by_frames, pad_edges, window_sums
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.quant import ieee_div, round_u8, sqrt_f32

f32 = np.float32


def ink(img: torch.Tensor, edge_strength: float, threshold: float,
        mask=None) -> torch.Tensor:
    """Sobel on BT.709 luma -> black where the edge exceeds the threshold,
    white elsewhere (artistic.rs:31-101), of u8 [..., H, W, 4]; alpha
    kept."""
    es = float(f32(edge_strength))
    thresh = float(f32(threshold))

    def run(x):
        h, w = x.shape[-3], x.shape[-2]
        src = x.float()
        lum = 0.2126 * src[..., 0] + 0.7152 * src[..., 1] + 0.0722 * src[..., 2]
        lpad = pad_edges(pad_edges(lum, 1, -2), 1, -1)

        def lm(dx, dy):
            return lpad[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

        gx = (-lm(-1, -1) - 2.0 * lm(-1, 0) - lm(-1, 1)
              + lm(1, -1) + 2.0 * lm(1, 0) + lm(1, 1))
        gy = (-lm(-1, -1) - 2.0 * lm(0, -1) - lm(1, -1)
              + lm(-1, 1) + 2.0 * lm(0, 1) + lm(1, 1))
        edge = ieee_div(sqrt_f32(gx * gx + gy * gy) * es, 100.0)
        val = torch.where(edge > thresh, 0, 255).to(torch.uint8)
        return torch.stack([val, val, val, x[..., 3]], dim=-1)

    return _masked(img, by_frames(run, img), mask)


def oil_painting(img: torch.Tensor, radius: int, levels: int, mask=None) -> torch.Tensor:
    """Mean colour of the modal intensity bin of the (2r+1)^2 window
    (artistic.rs:123-218), of u8 [..., H, W, 4], r clipped to [1, 10] and
    the levels to [2, 64]; alpha kept."""
    r = int(np.clip(radius, 1, 10))
    n_levels = int(np.clip(levels, 2, 64))

    def box(m):  # [..., H, W] integer -> window sums, edges replicated
        return window_sums(window_sums(m, r, -1), r, -2)

    def run(x):
        src = x.int()
        inten = torch.clamp((src[..., 0] + src[..., 1] + src[..., 2]) // 3
                            * n_levels // 256, max=n_levels - 1)
        best_cnt = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
        best = torch.zeros(x.shape[:-1] + (3,), dtype=torch.int32, device=x.device)
        for lvl in range(n_levels):
            ind = (inten == lvl).int()
            cnt = box(ind)
            sums = torch.stack([box(ind * src[..., c]) for c in range(3)], dim=-1)
            take = cnt > best_cnt
            best_cnt = torch.where(take, cnt, best_cnt)
            best = torch.where(take[..., None], sums, best)
        rgb = (best // torch.clamp(best_cnt, min=1)[..., None]).to(torch.uint8)
        return torch.cat([rgb, x[..., 3:4]], dim=-1)

    return _masked(img, by_frames(run, img), mask)


class ColorFilterMode(enum.IntEnum):
    MULTIPLY = 0
    SCREEN = 1
    OVERLAY = 2
    SOFT_LIGHT = 3


def color_filter(img, filter_color, intensity: float, mode=ColorFilterMode.MULTIPLY,
                 mask=None, device="cuda") -> torch.Tensor:
    """Per-channel constant-colour blend lerped by intensity
    (artistic.rs:218-310) of u8 [..., H, W, 4] (a tensor, or numpy moved to
    `device`); alpha kept."""
    x = as_image(img, device)
    mode = ColorFilterMode(mode)
    inten = f32(intensity)
    keep = float(f32(1.0) - inten)
    fcs = [f32(int(c)) / f32(255.0) for c in tuple(filter_color)[:3]]

    def blend(s, fv):
        if mode == ColorFilterMode.MULTIPLY:
            return s * float(fv)
        if mode == ColorFilterMode.SCREEN:
            return 1.0 - (1.0 - s) * float(f32(1.0) - fv)
        if mode == ColorFilterMode.OVERLAY:
            return torch.where(s < 0.5, 2.0 * s * float(fv),
                               1.0 - 2.0 * (1.0 - s) * float(f32(1.0) - fv))
        if fv < 0.5:
            return s - float(f32(1.0) - f32(2.0) * fv) * s * (1.0 - s)
        return s + float(f32(2.0) * fv - f32(1.0)) * (sqrt_f32(s) - s)

    def run(t):
        src = t.float()
        chans = []
        for c in range(3):
            s = ieee_div(src[..., c], 255.0)
            chans.append((s * keep + blend(s, fcs[c]) * float(inten)) * 255.0)
        return round_u8(torch.stack(chans + [src[..., 3]], dim=-1))

    return _masked(x, by_frames(run, x), mask)
