"""Gradient generation, the gradient tool (paintfe_tpu.ops.gradient
counterpart).

Behavioral contract: src/gpu/shaders.rs GRADIENT (:1276-1390) +
src/ui/panels/tools/state.rs (compute_t :1175-1229, rebuild_lut
:1063-1128): shapes Linear / LinearReflected / Radial / Diamond, clamp or
repeat, multi-stop LUT sampling (color = lut[u32(t*255)]), color or
eraser mode.  LinearReflected is a triangle wave peaked at the midpoint
(1 - |2t - 1|, rem_euclid(2) when repeating); a degenerate start == end
yields t = 0 everywhere; the eraser bakes luminance * stop alpha into a
mask and the commit multiplies layer alpha by (1 - mask) with a
truncating cast (canvas_state_impl.rs:415-421).

The 256-entry LUT is built on the host (numpy, as the JAX package).  The
t-field, the LUT gather and the eraser run on a torch device, the card
unless the caller passes "cpu", in the JAX package's f32 order: the
reference multiplies by host f32 reciprocals of the length and squared
length, and so does this (never a divide); the radial sqrt is correctly
rounded (`sqrt_f32`: torch's CPU sqrt is not); the LUT index truncates.
IEEE-basic, so byte-equal to the JAX package.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from paintfe_tpu_torch.utils.device import resolve_device
from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32


class GradientShape(enum.IntEnum):
    LINEAR = 0
    LINEAR_REFLECTED = 1
    RADIAL = 2
    DIAMOND = 3


def gradient_lut(stops) -> np.ndarray:
    """256x4 u8 LUT from (position, rgba) stops (rebuild_lut parity:
    half-away rounding, first-matching segment, endpoint clamping)."""
    lut = np.zeros((256, 4), np.uint8)
    stops = list(stops)
    if not stops:
        return lut
    if len(stops) == 1:
        lut[:] = np.asarray(stops[0][1], np.uint8)
        return lut
    srt = sorted(stops, key=lambda s: s[0])
    for i in range(256):
        t = f32(i) / f32(255.0)
        if t <= srt[0][0]:
            lut[i] = np.asarray(srt[0][1], np.uint8)
        elif t >= srt[-1][0]:
            lut[i] = np.asarray(srt[-1][1], np.uint8)
        else:
            left, right = srt[0], srt[-1]
            for j in range(len(srt) - 1):
                if srt[j][0] <= t <= srt[j + 1][0]:
                    left, right = srt[j], srt[j + 1]
                    break
            span = f32(right[0]) - f32(left[0])
            lt = f32((t - f32(left[0])) / span) if span > 0.0 else f32(0.0)
            inv = f32(1.0) - lt
            lc = np.asarray(left[1], f32)
            rc = np.asarray(right[1], f32)
            lut[i] = np.floor(lc * inv + rc * lt + f32(0.5)).astype(np.uint8)
    return lut


def gradient_t(shape, start, end, repeat, h: int, w: int, device="cuda") -> torch.Tensor:
    """The gradient parameter t of every pixel, f32 [H, W] on `device` (the
    card unless the caller passes "cpu")."""
    device = resolve_device(device)
    shape = GradientShape(shape)
    sx, sy = f32(start[0]), f32(start[1])
    ex, ey = f32(end[0]), f32(end[1])
    dx, dy = ex - sx, ey - sy
    len_sq = f32(dx * dx + dy * dy)
    if len_sq < 1e-6:  # the shader's inv_len selects 0: t = 0
        return torch.zeros((h, w), dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :] + 0.5 - float(sx)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] + 0.5 - float(sy)
    # host f32 reciprocals that the reference multiplies by
    # (perspective_gradient.rs:419-421)
    inv_len_sq = float(f32(1.0) / len_sq)
    inv_len = float(f32(1.0) / f32(np.sqrt(len_sq)))
    if shape in (GradientShape.LINEAR, GradientShape.LINEAR_REFLECTED):
        raw = (xs * float(dx) + ys * float(dy)) * inv_len_sq
        if shape == GradientShape.LINEAR_REFLECTED:
            # triangle wave peaked at the midpoint (state.rs:1192-1201)
            if repeat:
                t_mod = raw - torch.floor(ieee_div(raw, 2.0)) * 2.0
                return torch.where(t_mod > 1.0, 2.0 - t_mod, t_mod)
            return 1.0 - torch.abs(2.0 * torch.clamp(raw, 0.0, 1.0) - 1.0)
    elif shape == GradientShape.RADIAL:
        raw = sqrt_f32(xs * xs + ys * ys) * inv_len
    else:  # DIAMOND: (|proj| * inv_len) + (|perp| * inv_len)
        ux, uy = float(dx * f32(inv_len)), float(dy * f32(inv_len))
        proj = torch.abs(xs * ux + ys * uy) * inv_len
        perp = torch.abs(xs * (-uy) + ys * ux) * inv_len
        raw = proj + perp
    if repeat:
        return raw - torch.floor(raw)
    return torch.clamp(raw, 0.0, 1.0)


def render_gradient(w: int, h: int, start, end, color_a=None, color_b=None,
                    shape=GradientShape.LINEAR, repeat=False,
                    base=None, eraser=False, stops=None, device="cuda") -> torch.Tensor:
    """Render a gradient (or an eraser ramp over `base`) on `device`; returns
    a u8 [H, W, 4] tensor there.

    Either two colors (color_a at t=0, color_b at t=1) or explicit
    multi-stop `stops` = [(position, rgba), ...].  Colors come from the
    256-entry LUT at index u32(t*255): the shader's quantized sampling, not
    a continuous lerp.  `base` (numpy or a tensor) is the layer the eraser
    works on."""
    dev = resolve_device(device) if not isinstance(base, torch.Tensor) else base.device
    if stops is None:
        stops = [(0.0, color_a), (1.0, color_b)]
    lut = torch.from_numpy(gradient_lut(stops)).to(dev)
    t = gradient_t(shape, (float(start[0]), float(start[1])),
                   (float(end[0]), float(end[1])), bool(repeat), h, w, dev)
    idx = torch.clamp((t * 255.0).int(), max=255)  # u32 truncation
    color = lut[idx.long()]
    if not eraser:
        return color
    if base is None:
        raise ValueError("eraser gradient needs a base image")
    # mask = luminance * stop alpha, stored through rgba8unorm (rounds); the
    # commit multiplies layer alpha by (1 - mask) with a truncating cast,
    # only where the mask is nonzero
    cf = ieee_div(color.float(), 255.0)
    lum = 0.299 * cf[..., 0] + 0.587 * cf[..., 1] + 0.114 * cf[..., 2]
    mask_u8 = torch.floor(lum * cf[..., 3] * 255.0 + 0.5)
    src = (base if isinstance(base, torch.Tensor)
           else torch.from_numpy(np.ascontiguousarray(base, np.uint8))).to(dev)
    cur_a = ieee_div(src[..., 3].float(), 255.0)
    new_a = (cur_a * (1.0 - ieee_div(mask_u8, 255.0)) * 255.0).to(torch.uint8)
    out = src.clone()
    out[..., 3] = torch.where(mask_u8 > 0, new_a, src[..., 3])
    return out
