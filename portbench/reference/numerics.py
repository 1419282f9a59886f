"""Rounding and divides of the reference's u8 semantics."""

from __future__ import annotations

import math

import numpy as np
import torch

f32 = np.float32


def ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true divide on every device (a divide by a host scalar
    becomes a multiply by its reciprocal on CUDA)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sqrt_f(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt in x's dtype: an f64 sqrt rounded once."""
    return torch.sqrt(x.double()).to(x.dtype)


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half up, clamp to [0, 255], cast to u8."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 255], then truncate toward zero."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def gaussian_taps(sigma: float) -> np.ndarray:
    """1-D Gaussian truncated at ceil(3 sigma), normalised, in f32."""
    radius = int(math.ceil(sigma * 3.0))
    if radius == 0:
        return np.ones(1, f32)
    xs = np.arange(2 * radius + 1, dtype=f32) - f32(radius)
    s2 = f32(2.0) * f32(sigma) * f32(sigma)
    k = np.exp(-xs * xs / s2).astype(f32)
    inv = f32(1.0) / f32(k.sum(dtype=f32))
    return (k * inv).astype(f32)
