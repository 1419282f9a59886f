"""The headline chain: Gaussian blur, brightness/contrast, levels, sepia
with strength, then a soft-light flatten of an overlay (u8 [H, W, 4] x2)."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import gaussian_blur
from portbench.reference.blend import SOFT_LIGHT, blend_u8

f32 = np.float32


def bc_factor(contrast) -> np.float32:
    c = f32(contrast)
    return (f32(259.0) * (c + f32(255.0))) / (f32(255.0) * (f32(259.0) - c))


def brightness_contrast(img, brightness, contrast, ft=torch.float32):
    factor = float(bc_factor(contrast))
    f = img[..., 0:3].to(ft)
    rgb = torch.clamp(factor * (f + float(f32(brightness)) - 128.0) + 128.0, 0.0, 255.0)
    return torch.cat([rgb.to(torch.uint8), img[..., 3:4]], dim=-1)


def levels_lut(black, white, gamma) -> np.ndarray:
    """Levels as a 256-entry u8 table: f32 math, the power an f64 pow
    rounded once to f32."""
    in_black = f32(black)
    in_range = np.maximum(f32(white) - in_black, f32(1.0))
    inv_gamma = float(f32(1.0) / np.maximum(f32(gamma), f32(0.01)))
    i = np.arange(256, dtype=f32)
    normalized = np.clip((i - in_black) / in_range, 0.0, 1.0)
    powed = np.array([math.pow(float(x), inv_gamma) for x in normalized], f32)
    return np.clip(powed * f32(255.0), 0.0, 255.0).astype(np.uint8)


def levels(img, black, white, gamma, ft=torch.float32):
    """Through the table in f32; the control takes the table's math in ft."""
    if ft == torch.float32:
        lut = torch.from_numpy(levels_lut(black, white, gamma)).to(img.device)
    else:
        i = torch.arange(256, dtype=ft, device=img.device)
        rng = max(float(f32(white) - f32(black)), 1.0)
        x = torch.clamp((i - float(f32(black))) / rng, 0.0, 1.0)
        lut = torch.clamp(x ** (1.0 / max(float(gamma), 0.01)) * 255.0, 0.0, 255.0).to(torch.uint8)
    return torch.cat([lut[img[..., 0:3].long()], img[..., 3:4]], dim=-1)


def sepia(img, strength=None, ft=torch.float32):
    """Sepia with a truncating cast, lerped by strength."""
    f = img.to(ft)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    sr = torch.clamp(r * 0.393 + g * 0.769 + b * 0.189, max=255.0)
    sg = torch.clamp(r * 0.349 + g * 0.686 + b * 0.168, max=255.0)
    sb = torch.clamp(r * 0.272 + g * 0.534 + b * 0.131, max=255.0)
    if strength is not None:
        s = f32(np.clip(strength, 0.0, 1.0))
        inv, s = float(f32(1.0) - s), float(s)
        sr, sg, sb = r * inv + sr * s, g * inv + sg * s, b * inv + sb * s
    out = torch.stack([sr, sg, sb], dim=-1).to(torch.uint8)
    return torch.cat([out, img[..., 3:4]], dim=-1)


def apply(img, overlay, *, sigma, brightness, contrast, black, white, gamma,
          sepia_strength, blend_opacity, ft=torch.float32):
    x = gaussian_blur.apply(img, sigma, ft)
    x = brightness_contrast(x, brightness, contrast, ft)
    x = levels(x, black, white, gamma, ft)
    x = sepia(x, sepia_strength, ft)
    return blend_u8(x, overlay, SOFT_LIGHT, blend_opacity, ft)


def context_rows(sigma: float) -> int:
    """Rows of context a strip of the chain needs on each side."""
    return gaussian_blur.radius(sigma)
