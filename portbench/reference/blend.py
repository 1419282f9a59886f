"""The 25 blend modes of the document model: straight alpha, Porter-Duff
source-over with un-premultiply, a truncating u8 cast, and two fast paths
(a clear top pixel keeps the base; NORMAL at full opacity with an opaque
top pixel gives the top)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.numerics import ieee_div, sqrt_f, trunc_u8

NORMAL, XOR, OVERWRITE, SOFT_LIGHT = 0, 13, 14, 16
MODES = 25


def _overlay(b, t):
    return torch.where(b < 0.5, 2.0 * b * t, 1.0 - 2.0 * (1.0 - b) * (1.0 - t))


def _color_burn(b, t):
    safe = torch.where(t == 0.0, 1.0, t)
    return torch.where(t == 0.0, 0.0, torch.clamp(1.0 - (1.0 - b) / safe, min=0.0))


def _color_dodge(b, t):
    safe = torch.where(t >= 1.0, 1.0, 1.0 - t)
    return torch.where(t >= 1.0, 1.0, torch.clamp(b / safe, max=1.0))


def _reflect(b, t):
    safe = torch.where(t >= 1.0, 1.0, 1.0 - t)
    return torch.where(t >= 1.0, 1.0, torch.clamp(b * b / safe, max=1.0))


def _soft_light(b, t):
    d = torch.where(b <= 0.25, ((16.0 * b - 12.0) * b + 4.0) * b, sqrt_f(b))
    return torch.where(t <= 0.5, b - (1.0 - 2.0 * t) * b * (1.0 - b),
                       b + (2.0 * t - 1.0) * (d - b))


def _divide(b, t):
    safe = torch.where(t <= 0.0, 1.0, t)
    return torch.where(t <= 0.0, 1.0, torch.clamp(b / safe, max=1.0))


def _vivid_light(b, t):
    t2_lo = 2.0 * t
    lo_safe = torch.where(t2_lo <= 0.0, 1.0, t2_lo)
    lo = torch.where(t2_lo <= 0.0, 0.0, torch.clamp(1.0 - (1.0 - b) / lo_safe, min=0.0))
    t2_hi = 2.0 * (t - 0.5)
    hi_safe = torch.where(t2_hi >= 1.0, 1.0, 1.0 - t2_hi)
    hi = torch.where(t2_hi >= 1.0, 1.0, torch.clamp(b / hi_safe, max=1.0))
    return torch.where(t <= 0.5, lo, hi)


def _pin_light(b, t):
    return torch.where(t <= 0.5, torch.minimum(b, 2.0 * t), torch.maximum(b, 2.0 * (t - 0.5)))


# mode id -> channel mixer of f [0, 1] values (XOR and OVERWRITE have none)
MIXERS = {
    0: lambda b, t: t,
    1: lambda b, t: b * t,
    2: lambda b, t: 1.0 - (1.0 - b) * (1.0 - t),
    3: lambda b, t: torch.clamp(b + t, max=1.0),
    4: _reflect,
    5: lambda b, t: _reflect(t, b),
    6: _color_burn,
    7: _color_dodge,
    8: _overlay,
    9: lambda b, t: torch.abs(b - t),
    10: lambda b, t: 1.0 - torch.abs(1.0 - b - t),
    11: torch.maximum,
    12: torch.minimum,
    15: lambda b, t: _overlay(t, b),
    16: _soft_light,
    17: lambda b, t: b + t - 2.0 * b * t,
    18: lambda b, t: torch.clamp(b - t, min=0.0),
    19: _divide,
    20: lambda b, t: torch.clamp(b + t - 1.0, min=0.0),
    21: _vivid_light,
    22: lambda b, t: torch.clamp(b + 2.0 * t - 1.0, 0.0, 1.0),
    23: _pin_light,
    24: lambda b, t: torch.where(b + t >= 1.0, 1.0, 0.0),
}


def _porter_duff(mixer, base_f, top_rgb, top_a):
    base_rgb, base_a = base_f[..., 0:3], base_f[..., 3:4]
    rgb = mixer(base_rgb, top_rgb)
    inv = 1.0 - top_a
    out_a = top_a + base_a * inv
    safe_a = torch.where(out_a == 0.0, 1.0, out_a)
    out_rgb = (rgb * top_a + base_rgb * base_a * inv) / safe_a
    out = torch.cat([out_rgb, out_a], dim=-1)
    out = torch.where(out_a == 0.0, 0.0, out)
    return trunc_u8(out * 255.0)


def _xor(base_f, top_rgb, top_a):
    base_rgb, base_a = base_f[..., 0:3], base_f[..., 3:4]
    xor_a = base_a * (1.0 - top_a) + top_a * (1.0 - base_a)
    safe_a = torch.where(xor_a == 0.0, 1.0, xor_a)
    xor_rgb = (base_rgb * base_a * (1.0 - top_a) + top_rgb * top_a * (1.0 - base_a)) / safe_a
    out = torch.cat([xor_rgb, xor_a], dim=-1)
    out = torch.where(xor_a == 0.0, 0.0, out)
    return trunc_u8(out * 255.0)


def _overwrite(base_f, top_rgb, top_a):
    return trunc_u8(torch.cat([top_rgb, top_a], dim=-1) * 255.0)


def clip_opacity(opacity) -> float:
    """The opacity as the f32 value in [0, 1] that the blend multiplies by."""
    return float(np.clip(np.float32(opacity), np.float32(0.0), np.float32(1.0)))


def blend_u8(base: torch.Tensor, top: torch.Tensor, mode: int, opacity,
             ft=torch.float32) -> torch.Tensor:
    """`top` over `base` (u8 [..., 4]) with one mode and opacity."""
    mode = int(mode)
    opacity = clip_opacity(opacity)
    base_f = ieee_div(base.to(ft), 255.0)
    top_f = ieee_div(top.to(ft), 255.0)
    top_rgb = top_f[..., 0:3]
    top_a = top_f[..., 3:4] * opacity
    if mode == OVERWRITE:
        blended = _overwrite(base_f, top_rgb, top_a)
    elif mode == XOR:
        blended = _xor(base_f, top_rgb, top_a)
    else:
        blended = _porter_duff(MIXERS[mode], base_f, top_rgb, top_a)
    if mode == NORMAL and opacity >= 1.0:
        blended = torch.where(top[..., 3:4] == 255, top, blended)
    return torch.where(top[..., 3:4] == 0, base, blended)
