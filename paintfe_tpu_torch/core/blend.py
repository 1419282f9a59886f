"""The 25 blend modes (23 channel mixers plus XOR and OVERWRITE), as plain
torch ops.

Same contract as paintfe_tpu.core.blend: straight (non-premultiplied)
alpha, Porter-Duff source-over with un-premultiply, a truncating u8 cast,
and two fast paths — a fully transparent top pixel returns the base pixel
unchanged, and NORMAL at full opacity with an opaque top pixel returns the
top pixel unchanged.  Every arithmetic step is a separate IEEE f32 op in
the JAX package's order, so the bytes match it.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32, trunc_u8


class BlendMode(enum.IntEnum):
    """Stable ids match the reference's serialization (layers.rs:125-185)."""

    NORMAL = 0
    MULTIPLY = 1
    SCREEN = 2
    ADDITIVE = 3
    REFLECT = 4
    GLOW = 5
    COLOR_BURN = 6
    COLOR_DODGE = 7
    OVERLAY = 8
    DIFFERENCE = 9
    NEGATION = 10
    LIGHTEN = 11
    DARKEN = 12
    XOR = 13
    OVERWRITE = 14
    HARD_LIGHT = 15
    SOFT_LIGHT = 16
    EXCLUSION = 17
    SUBTRACT = 18
    DIVIDE = 19
    LINEAR_BURN = 20
    VIVID_LIGHT = 21
    LINEAR_LIGHT = 22
    PIN_LIGHT = 23
    HARD_MIX = 24

    @classmethod
    def from_name(cls, name: str) -> "BlendMode":
        return cls[name.strip().upper().replace(" ", "_")]


# ---------------------------------------------------------------------------
# Channel mixers (f32 in [0,1]).  Divisors are guarded so both sides of a
# torch.where stay finite.
# ---------------------------------------------------------------------------


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
    # W3C soft-light formula
    d = torch.where(b <= 0.25, ((16.0 * b - 12.0) * b + 4.0) * b, sqrt_f32(b))
    return torch.where(
        t <= 0.5,
        b - (1.0 - 2.0 * t) * b * (1.0 - b),
        b + (2.0 * t - 1.0) * (d - b),
    )


def _divide(b, t):
    safe = torch.where(t <= 0.0, 1.0, t)
    return torch.where(t <= 0.0, 1.0, torch.clamp(b / safe, max=1.0))


def _vivid_light(b, t):
    t2_lo = 2.0 * t
    lo_safe = torch.where(t2_lo <= 0.0, 1.0, t2_lo)
    lo = torch.where(t2_lo <= 0.0, 0.0,
                     torch.clamp(1.0 - (1.0 - b) / lo_safe, min=0.0))
    t2_hi = 2.0 * (t - 0.5)
    hi_safe = torch.where(t2_hi >= 1.0, 1.0, 1.0 - t2_hi)
    hi = torch.where(t2_hi >= 1.0, 1.0, torch.clamp(b / hi_safe, max=1.0))
    return torch.where(t <= 0.5, lo, hi)


def _pin_light(b, t):
    return torch.where(t <= 0.5, torch.minimum(b, 2.0 * t),
                       torch.maximum(b, 2.0 * (t - 0.5)))


_RGB_MIXERS = {
    BlendMode.NORMAL: lambda b, t: t,
    BlendMode.MULTIPLY: lambda b, t: b * t,
    BlendMode.SCREEN: lambda b, t: 1.0 - (1.0 - b) * (1.0 - t),
    BlendMode.ADDITIVE: lambda b, t: torch.clamp(b + t, max=1.0),
    BlendMode.REFLECT: _reflect,
    BlendMode.GLOW: lambda b, t: _reflect(t, b),
    BlendMode.COLOR_BURN: _color_burn,
    BlendMode.COLOR_DODGE: _color_dodge,
    BlendMode.OVERLAY: _overlay,
    BlendMode.DIFFERENCE: lambda b, t: torch.abs(b - t),
    BlendMode.NEGATION: lambda b, t: 1.0 - torch.abs(1.0 - b - t),
    BlendMode.LIGHTEN: torch.maximum,
    BlendMode.DARKEN: torch.minimum,
    BlendMode.HARD_LIGHT: lambda b, t: _overlay(t, b),
    BlendMode.SOFT_LIGHT: _soft_light,
    BlendMode.EXCLUSION: lambda b, t: b + t - 2.0 * b * t,
    BlendMode.SUBTRACT: lambda b, t: torch.clamp(b - t, min=0.0),
    BlendMode.DIVIDE: _divide,
    BlendMode.LINEAR_BURN: lambda b, t: torch.clamp(b + t - 1.0, min=0.0),
    BlendMode.VIVID_LIGHT: _vivid_light,
    BlendMode.LINEAR_LIGHT: lambda b, t: torch.clamp(b + 2.0 * t - 1.0, 0.0, 1.0),
    BlendMode.PIN_LIGHT: _pin_light,
    BlendMode.HARD_MIX: lambda b, t: torch.where(b + t >= 1.0, 1.0, 0.0),
}


def _porter_duff(mixer, base_f, top_rgb, top_a):
    """Source-over compositing of the mixed color, straight alpha: the
    tail of the reference's blend_pixel_static (zero coverage gives
    transparent black, truncating u8 cast)."""
    base_rgb = base_f[..., 0:3]
    base_a = base_f[..., 3:4]
    rgb = mixer(base_rgb, top_rgb)
    inv = 1.0 - top_a
    out_a = top_a + base_a * inv
    safe_a = torch.where(out_a == 0.0, 1.0, out_a)
    out_rgb = (rgb * top_a + base_rgb * base_a * inv) / safe_a
    out = torch.cat([out_rgb, out_a], dim=-1)
    out = torch.where(out_a == 0.0, 0.0, out)
    return trunc_u8(out * 255.0)


def _xor_branch(base_f, top_rgb, top_a):
    base_rgb = base_f[..., 0:3]
    base_a = base_f[..., 3:4]
    xor_a = base_a * (1.0 - top_a) + top_a * (1.0 - base_a)
    safe_a = torch.where(xor_a == 0.0, 1.0, xor_a)
    xor_rgb = (base_rgb * base_a * (1.0 - top_a)
               + top_rgb * top_a * (1.0 - base_a)) / safe_a
    out = torch.cat([xor_rgb, xor_a], dim=-1)
    out = torch.where(xor_a == 0.0, 0.0, out)
    return trunc_u8(out * 255.0)


def _overwrite_branch(base_f, top_rgb, top_a):
    return trunc_u8(torch.cat([top_rgb, top_a], dim=-1) * 255.0)


def _branch(mode: BlendMode):
    if mode == BlendMode.OVERWRITE:
        return _overwrite_branch
    if mode == BlendMode.XOR:
        return _xor_branch
    mixer = _RGB_MIXERS[mode]
    return lambda bf, tr, ta: _porter_duff(mixer, bf, tr, ta)


def clip_opacity(opacity) -> float:
    """The opacity as the f32 value in [0, 1] that the blend multiplies by."""
    return float(np.clip(np.float32(opacity), np.float32(0.0), np.float32(1.0)))


def blend_u8(base: torch.Tensor, top: torch.Tensor, mode, opacity) -> torch.Tensor:
    """Blend `top` over `base` (both u8 [..., 4], same device) with a
    scalar mode and opacity in [0, 1]."""
    mode = BlendMode(int(mode))
    opacity = clip_opacity(opacity)
    base_f = ieee_div(base.float(), 255.0)
    top_f = ieee_div(top.float(), 255.0)
    top_rgb = top_f[..., 0:3]
    top_a = top_f[..., 3:4] * opacity
    blended = _branch(mode)(base_f, top_rgb, top_a)

    # Fast path 2: Normal, full opacity, opaque top pixel -> top verbatim.
    if mode == BlendMode.NORMAL and opacity >= 1.0:
        blended = torch.where(top[..., 3:4] == 255, top, blended)

    # Fast path 1: fully transparent top pixel -> base verbatim (checked on
    # the raw alpha, before opacity scaling, like the reference).
    return torch.where(top[..., 3:4] == 0, base, blended)
