"""The Gaussian blur (paintfe_tpu.ops.filters, Gaussian section).

Behavioral contract: src/ops/filters.rs — separable Gaussian, kernel
truncated at ceil(3*sigma), H pass u8->f32, V pass f32->u8 round-half-up,
f32 sums in reference tap order.  The blur runs through the K-blur kernel
wrapper (ops/kernels.py), which on a CPU tensor takes its plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import masked as _masked

f32 = np.float32


def gaussian_kernel(sigma: float) -> np.ndarray:
    """1-D kernel truncated at ceil(3*sigma), normalized (f32 exact)."""
    radius = int(math.ceil(sigma * 3.0))
    if radius == 0:
        return np.ones(1, f32)
    xs = np.arange(2 * radius + 1, dtype=f32) - f32(radius)
    s2 = f32(2.0) * f32(sigma) * f32(sigma)
    k = np.exp(-xs * xs / s2).astype(f32)
    inv = f32(1.0) / f32(k.sum(dtype=f32))
    return (k * inv).astype(f32)


def gaussian_blur(img: torch.Tensor, sigma: float, mask=None) -> torch.Tensor:
    """Separable Gaussian blur of u8 [H, W, 4] or [B, H, W, 4]
    (filters.rs:242-316); masked-out pixels keep the input."""
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_fused

    return _masked(img, gaussian_blur_fused(img, float(sigma)), mask)


def gaussian_blur_with_selection(img: torch.Tensor, sigma: float,
                                 mask=None) -> torch.Tensor:
    """Selection-aware Gaussian: blur only the padded selection bbox, then
    copy selected pixels back (filters.rs:130-207).  The bbox is a host
    decision, and clamping happens at the cutout's edges like the
    reference's region cutout.  `mask` is u8 [H, W] (numpy), or None."""
    if mask is None:
        return gaussian_blur(img, sigma)
    m = np.asarray(mask)
    if not m.any():
        return img  # nothing selected
    ys, xs = np.nonzero(m)
    pad = int(math.ceil(sigma * 3.0))
    h, w = img.shape[:2]
    y0 = max(int(ys.min()) - pad, 0)
    y1 = min(int(ys.max()) + pad + 1, h)
    x0 = max(int(xs.min()) - pad, 0)
    x1 = min(int(xs.max()) + pad + 1, w)
    region = img[y0:y1, x0:x1].contiguous()
    blurred = gaussian_blur(region, sigma)
    sel = torch.from_numpy(m[y0:y1, x0:x1] > 0).to(img.device)
    out = img.clone()
    out[y0:y1, x0:x1] = torch.where(sel[..., None], blurred, region)
    return out
