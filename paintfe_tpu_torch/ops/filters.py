"""The Gaussian blur and the median (paintfe_tpu.ops.filters, Gaussian
and median sections).

Behavioral contract: src/ops/filters.rs — separable Gaussian, kernel
truncated at ceil(3*sigma), H pass u8->f32, V pass f32->u8 round-half-up,
f32 sums in reference tap order; effects/noise.rs — per-channel median of
the (2r+1)^2 window, edges replicated.  The blur runs through the K-blur
kernel wrapper and the median through K-median's (ops/kernels.py); on a
CPU tensor each takes its plain version.
"""

from __future__ import annotations

import functools
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


# ---------------------------------------------------------------------------
# Median
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _oddeven_merge_network(n: int):
    """Batcher odd-even mergesort comparator list for n inputs (pairs i<j).
    O(n log^2 n) compare-exchanges; sorts any input exactly."""
    # Batcher's construction needs a power-of-two width; pad virtually and
    # drop comparators that touch the padding (padding sorts as +inf).
    m = 1
    while m < n:
        m *= 2
    comparators = []

    def merge(lo, nn, step):
        dbl = step * 2
        if dbl < nn:
            merge(lo, nn, dbl)
            merge(lo + step, nn, dbl)
            for i in range(lo + step, lo + nn - step, dbl):
                comparators.append((i, i + step))
        elif lo + step < lo + nn:
            comparators.append((lo, lo + step))

    def sort(lo, nn):
        if nn > 1:
            mid = nn // 2
            sort(lo, mid)
            sort(lo + mid, nn - mid)
            merge(lo, nn, 1)

    sort(0, m)
    return [(i, j) for (i, j) in comparators if i < n and j < n]


def median(img: torch.Tensor, radius: int, mask=None) -> torch.Tensor:
    """Per-channel window-sort median (effects/noise.rs:357-411) of u8
    [H, W, 4] or [B, H, W, 4], r = max(radius, 1); masked-out pixels keep
    the input.  On the card it always launches K-median."""
    from paintfe_tpu_torch.ops.kernels import median_kernel

    return _masked(img, median_kernel(img, max(int(radius), 1)), mask)
