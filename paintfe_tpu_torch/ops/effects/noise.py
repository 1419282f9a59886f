"""Additive noise: Uniform, Gaussian and Perlin
(paintfe_tpu.ops.effects.noise counterpart).

Behavioral contract: src/ops/effects/noise.rs:52-143 — deterministic
coordinate-hash noise, colour mode re-derives per channel with seed
+0/1/2, strength = amount*255/100.

The noise offsets depend only on coordinates, the seed and the
parameters, so they are built once on the host (utils/hashing.py, in
numpy) and cached per (amount, type, mono, seed, scale, octaves, h, w),
as the JAX package caches its compiled function; the device adds them
to the pixels and rounds.  Uniform and Perlin noise are IEEE-basic and
byte-equal to the JAX package.  Gaussian noise takes a log and a cos of
hashed coordinates: under the transcendental rule (ROADMAP C2) each is
an f64 libm call of the f32 argument rounded once to f32, on the host,
so the port's CPU and card outputs are byte-equal to each other and
within 1 of the JAX package's u8 (XLA's f32 log and cos differ bitwise).
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.hashing import hash_f32, turbulence_2d
from paintfe_tpu_torch.utils.quant import round_u8

f32 = np.float32


class NoiseType(enum.IntEnum):
    UNIFORM = 0
    GAUSSIAN = 1
    PERLIN = 2


@functools.lru_cache(maxsize=4)  # up to 100 MB an entry at 3840x2160
def noise_offsets(amount, noise_type, monochrome, seed, scale, octaves, h, w) -> np.ndarray:
    """The f32 values added to R, G and B: [H, W, 1] for monochrome noise
    (one value for all three), else [H, W, 3]."""
    inv_scale = f32(1.0) / f32(max(scale, 0.1))
    oct_n = int(np.clip(octaves, 1, 8))
    strength = f32(f32(amount) * f32(255.0) / f32(100.0))
    xs = np.arange(w, dtype=f32)[None, :] * np.ones((h, 1), f32)
    ys = np.arange(h, dtype=f32)[:, None] * np.ones((1, w), f32)
    sx = xs * inv_scale
    sy = ys * inv_scale
    qx = np.floor(sx).astype(np.int32)
    qy = np.floor(sy).astype(np.int32)

    def chan_noise(s):
        if noise_type == NoiseType.PERLIN:
            return turbulence_2d(sx, sy, s, oct_n, 0.5) * f32(2.0) - f32(1.0)
        return hash_f32(qx, qy, s) * f32(2.0) - f32(1.0)

    if monochrome:
        if noise_type == NoiseType.UNIFORM:
            base = hash_f32(qx, qy, seed) * f32(2.0) - f32(1.0)
        elif noise_type == NoiseType.GAUSSIAN:
            u1 = np.maximum(hash_f32(qx, qy, seed), f32(0.0001))
            u2 = hash_f32(qx, qy, (seed + 7) & 0xFFFFFFFF)
            log_u1 = np.log(u1.astype(np.float64)).astype(f32)
            radius = np.sqrt((f32(-2.0) * log_u1).astype(np.float64)).astype(f32)
            angle = f32(f32(2.0) * f32(np.pi)) * u2
            cos = np.cos(angle.astype(np.float64)).astype(f32)
            base = radius * cos * f32(0.33)
        else:
            base = turbulence_2d(sx, sy, seed, oct_n, 0.5) * f32(2.0) - f32(1.0)
        planes = [base * strength]
    else:
        planes = [chan_noise((seed + k) & 0xFFFFFFFF) * strength for k in range(3)]
    return np.stack(planes, axis=-1).astype(f32)


def add_noise(img: torch.Tensor, amount, noise_type=NoiseType.UNIFORM, monochrome=False,
              seed=42, scale=1.0, octaves=1, mask=None) -> torch.Tensor:
    """Noise added to RGB of u8 [..., H, W, 4], rounded half up; alpha
    kept, and masked-out pixels keep the input."""
    h, w = img.shape[-3], img.shape[-2]
    offsets = noise_offsets(float(amount), NoiseType(noise_type), bool(monochrome),
                            int(seed), float(scale), int(octaves), h, w)
    n = torch.from_numpy(offsets).to(img.device)
    rgb = round_u8(img[..., 0:3].float() + n)
    return _masked(img, torch.cat([rgb, img[..., 3:4]], dim=-1), mask)
