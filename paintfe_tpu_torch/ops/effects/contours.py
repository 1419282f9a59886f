"""Contours effect: iso-lines of a turbulence field
(paintfe_tpu.ops.effects.contours counterpart).

Behavioral contract: src/ops/effects/contours.rs:56-160.

The turbulence field depends only on coordinates, the scale, the seed and
the octaves: it is built on the host (utils/hashing.turbulence_2d,
bit-identical to the JAX package) and cached per parameter set, as the
dents field is.  The levels, the line coverage and the mix run on the
device in the JAX package's f32 order, rounding half away from zero and
dividing truly: byte-equal to the JAX package.  `contours` takes a tensor
(run where it is) or a numpy image (moved to `device`, the card unless the
caller passes "cpu").
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import as_image
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.hashing import turbulence_2d
from paintfe_tpu_torch.utils.quant import ieee_div, round_half_away, round_u8

f32 = np.float32


@functools.lru_cache(maxsize=2)  # 33 MB an entry at 3840x2160
def contours_noise(scale: float, seed: int, octaves: int, h: int, w: int) -> np.ndarray:
    """The turbulence field of contours, f32 [H, W] (numpy, on the host):
    roughness 0.5, octaves clipped to [1, 8], coordinates over
    max(scale, 0.5)."""
    inv_scale = f32(1.0) / f32(max(scale, 0.5))
    oct_n = int(np.clip(octaves, 1, 8))
    xs = np.arange(w, dtype=f32)[None, :] * np.ones((h, 1), f32)
    ys = np.arange(h, dtype=f32)[:, None] * np.ones((1, w), f32)
    return np.ascontiguousarray(
        turbulence_2d(xs * inv_scale, ys * inv_scale, seed, oct_n, 0.5), f32)


def contours(img, scale, frequency, line_width, line_color, seed=42, octaves=2,
             blend=0.5, mask=None, device="cuda") -> torch.Tensor:
    x = as_image(img, device)
    h, w = x.shape[:2]
    inv_scale = f32(1.0) / f32(max(float(scale), 0.5))
    half_lw = f32(max(float(line_width) * 0.5, 0.3))
    col = np.asarray(tuple(int(c) for c in line_color), f32)
    la = float(f32(col[3] / f32(255.0)))
    freq = float(f32(max(float(frequency), 0.5)))
    edge = f32(half_lw * inv_scale * f32(0.5))
    noise = torch.from_numpy(contours_noise(float(scale), int(seed), int(octaves),
                                            h, w)).to(x.device)
    level = noise * freq
    nearest = round_half_away(level)
    dist = ieee_div(torch.abs(level - nearest), freq)
    line_alpha = torch.where(
        dist < float(edge), 1.0,
        torch.where(dist < float(edge * f32(2.0)),
                    1.0 - ieee_div(dist - float(edge), float(edge)), 0.0))
    alpha = (line_alpha * la * float(f32(blend)))[..., None]
    src = x.float()
    rgb = src[..., 0:3] * (1.0 - alpha) + torch.from_numpy(col[0:3]).to(x.device) * alpha
    out = round_u8(torch.cat([rgb, src[..., 3:4]], dim=-1))
    return _masked(x, out, mask)
