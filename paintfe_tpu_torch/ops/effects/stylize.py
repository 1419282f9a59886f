"""Stylize effects: vignette and halftone (paintfe_tpu.ops.effects.stylize
counterpart; glow and sharpen live in ops/filters.py beside the Gaussian).

Behavioral contract: src/ops/effects/stylize.rs — vignette (:170-191),
halftone luminance-vs-cell-distance threshold (:196-276).

Both are IEEE-basic (a sqrt and divides; halftone's cos and sin are of one
host scalar), so they are byte-equal to the JAX package.  The per-pixel
geometry (vignette's factor, halftone's threshold) depends only on
coordinates and the parameters: it is computed in f32 on the image's
device in the JAX package's order, with a correctly rounded sqrt and
divides (utils/quant.ieee_div).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from paintfe_tpu_torch.core.colorspace import luma_bt709
from paintfe_tpu_torch.ops.common import by_frames, coord_grids
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.ops.filters import to_radians_f32
from paintfe_tpu_torch.utils.quant import ieee_div, round_u8, sqrt_f32

f32 = np.float32


class HalftoneShape(enum.IntEnum):
    CIRCLE = 0
    SQUARE = 1
    DIAMOND = 2
    LINE = 3


def vignette_factor(amount: float, softness: float, h: int, w: int, device="cuda"):
    """vf = clip(1 - amount * min(dist / soft, 1)^2, 0, 1), f32 [H, W, 1]
    on `device` (the card unless the caller passes "cpu"), dist the
    distance to the centre over the half-diagonal."""
    from paintfe_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    wf, hf = f32(w), f32(h)
    cx = f32(wf / f32(2.0))
    cy = f32(hf / f32(2.0))
    max_dist = f32(np.sqrt(f32(cx * cx + cy * cy)))
    soft = f32(max(softness, 0.01))
    amt = float(f32(amount))
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :] - float(cx)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] - float(cy)
    dist = ieee_div(sqrt_f32(xs * xs + ys * ys), float(max_dist))
    t = torch.clamp(ieee_div(dist, float(soft)), max=1.0)
    return torch.clamp(1.0 - amt * t * t, 0.0, 1.0)[..., None]


def vignette(img: torch.Tensor, amount: float, softness: float, mask=None) -> torch.Tensor:
    """RGB of u8 [..., H, W, 4] times vignette_factor, rounded half up
    (stylize.rs:170-191); alpha kept."""
    h, w = img.shape[-3], img.shape[-2]
    vf = vignette_factor(amount, softness, h, w, img.device)

    def run(x):
        return torch.cat([round_u8(x[..., 0:3].float() * vf), x[..., 3:4]], dim=-1)

    return _masked(img, by_frames(run, img), mask)


def halftone_threshold(dot_size: float, angle_deg: float, shape, h: int, w: int,
                       device="cuda") -> torch.Tensor:
    """Each pixel's distance threshold in its rotated cell, f32 [H, W] on
    `device` (the card unless the caller passes "cpu"; CUDA with no card
    raises)."""
    from paintfe_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    ds = float(f32(max(dot_size, 2.0)))
    angle = to_radians_f32(angle_deg)
    cos_a = float(f32(np.cos(angle)))
    sin_a = float(f32(np.sin(angle)))
    xs, ys = coord_grids(h, w, device)
    fx = xs * cos_a + ys * sin_a
    fy = -xs * sin_a + ys * cos_a
    rx = ieee_div(fx, ds)
    ry = ieee_div(fy, ds)
    cx = torch.abs(rx - torch.trunc(rx)) - 0.5  # Rust fract().abs()
    cy = torch.abs(ry - torch.trunc(ry)) - 0.5
    if shape == HalftoneShape.CIRCLE:
        return sqrt_f32(cx * cx + cy * cy) * 2.0
    if shape == HalftoneShape.SQUARE:
        return torch.maximum(torch.abs(cx), torch.abs(cy)) * 2.0
    if shape == HalftoneShape.DIAMOND:
        return torch.abs(cx) + torch.abs(cy)
    return torch.abs(cy) * 2.0


def halftone(img: torch.Tensor, dot_size: float, angle_deg: float,
             shape=HalftoneShape.CIRCLE, mask=None) -> torch.Tensor:
    """Rotated-cell luminance thresholding (stylize.rs:242-276) of u8
    [..., H, W, 4]: RGB 255 where the threshold lies below the pixel's
    BT.709 luma over 255, else 0; alpha kept."""
    h, w = img.shape[-3], img.shape[-2]
    thresh = halftone_threshold(dot_size, angle_deg, HalftoneShape(shape), h, w, img.device)

    def run(x):
        src = x.float()
        lum = ieee_div(luma_bt709(src[..., 0], src[..., 1], src[..., 2]), 255.0)
        val = torch.where(thresh < lum, 255, 0).to(torch.uint8)
        return torch.stack([val, val, val, x[..., 3]], dim=-1)

    return _masked(img, by_frames(run, img), mask)
