"""Inverse-mapped distortion effects (paintfe_tpu.ops.effects.distort):
for now the edge-clamped bilinear sampler and the radial bulge.

Behavioral contract: src/ops/effects/distort.rs — radial bulge
(:396-437): dst(x, y) = src(f(x, y)) with an edge-clamped bilinear gather.
The field is computed in f32 on the image's device in the JAX package's
expression order; the gather runs through the K-warp kernel wrapper
(ops/warp_kernel.py, mode "clamp"), which on a CPU tensor takes its plain
version.  Twist and dents wait for a policy on sin/cos/atan2, which differ
bitwise between XLA and torch.
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import coord_grids
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.quant import ieee_div

f32 = np.float32


def sample_bilinear(img_u8: torch.Tensor, fx: torch.Tensor,
                    fy: torch.Tensor) -> torch.Tensor:
    """Edge-clamped bilinear sample of u8 [..., H, W, 4] at f32 [H', W']
    coordinates, as f32 [..., H', W', 4]; weight order matches
    effects.rs:118-140."""
    h, w = img_u8.shape[-3], img_u8.shape[-2]
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    dx = (fx - x0.float())[..., None]
    dy = (fy - y0.float())[..., None]

    def at(xi, yi):
        cx = torch.clamp(xi, 0, w - 1).long()
        cy = torch.clamp(yi, 0, h - 1).long()
        return img_u8[..., cy, cx, :].float()

    p00 = at(x0, y0)
    p10 = at(x0 + 1, y0)
    p01 = at(x0, y0 + 1)
    p11 = at(x0 + 1, y0 + 1)
    return (
        p00 * (1.0 - dx) * (1.0 - dy)
        + p10 * dx * (1.0 - dy)
        + p01 * (1.0 - dx) * dy
        + p11 * dx * dy
    )


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt on every device: torch's CPU sqrt is not
    (1 ulp low on some inputs), an f64 sqrt rounded once to f32 is."""
    return torch.sqrt(x.double()).float()


def _bulge_params(amount: float, ox: float, oy: float, h: int, w: int):
    wf, hf = f32(w), f32(h)
    cx = f32(np.clip(ox, 0.0, 1.0)) * max(wf - 1.0, 0.0)
    cy = f32(np.clip(oy, 0.0, 1.0)) * max(hf - 1.0, 0.0)
    max_r = f32(max(max(cx, wf - cx), max(cy, hf - cy), 1.0))
    strength = f32(max(abs(amount), 0.0001))
    return cx, cy, max_r, strength


def bulge_field(amount: float, origin, h: int, w: int, device="cpu"):
    """The bulge's source coordinates and normalized radius, each f32
    [H, W] on `device`: (src_x, src_y, norm)."""
    cx, cy, max_r, strength = _bulge_params(
        float(amount), float(origin[0]), float(origin[1]), h, w)
    cx, cy = float(f32(cx)), float(f32(cy))
    xs, ys = coord_grids(h, w, device)
    dx = xs - cx
    dy = ys - cy
    dist = _sqrt_f32(dx * dx + dy * dy)
    norm = torch.clamp(ieee_div(dist, float(max_r)), max=1.0)
    falloff = 1.0 - norm
    if amount > 0.0:
        factor = 1.0 - falloff * float(strength) * 0.5
    elif amount < 0.0:
        factor = 1.0 + falloff * float(strength) * 0.5
    else:
        factor = torch.ones_like(falloff)
    return cx + dx * factor, cy + dy * factor, norm


def bulge(img: torch.Tensor, amount: float, origin=(0.5, 0.5),
          mask=None) -> torch.Tensor:
    """Radial scale about origin, inverse-mapped bilinear (distort.rs:396-458)
    of u8 [H, W, 4] or [B, H, W, 4]; pixels at or beyond the radius keep
    the input, and so do masked-out pixels."""
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    h, w = img.shape[-3], img.shape[-2]
    src_x, src_y, norm = bulge_field(float(amount), origin, h, w, img.device)
    warped = gather_bilinear_u8(img, src_x, src_y, mode="clamp")
    out = torch.where((norm >= 1.0)[..., None], img, warped)
    return _masked(img, out, mask)
