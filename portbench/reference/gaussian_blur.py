"""Separable Gaussian blur of u8 [..., H, W, 4]: an H pass then a V pass,
each an ordered sum over taps of edge-clamped shifted copies, rounded half
up."""

from __future__ import annotations

import torch

from portbench.reference.numerics import gaussian_taps, round_u8


def apply(img: torch.Tensor, sigma: float, ft=torch.float32) -> torch.Tensor:
    taps = gaussian_taps(float(sigma))
    r = len(taps) // 2
    h, w = img.shape[-3], img.shape[-2]
    src = img.to(ft)
    cols = torch.arange(w, device=img.device)
    acc = torch.zeros_like(src)
    for k, t in enumerate(taps):
        idx = torch.clamp(cols + (k - r), 0, w - 1)
        acc = acc + src.index_select(-2, idx) * float(t)
    rows = torch.arange(h, device=img.device)
    out = torch.zeros_like(acc)
    for k, t in enumerate(taps):
        idx = torch.clamp(rows + (k - r), 0, h - 1)
        out = out + acc.index_select(-3, idx) * float(t)
    return round_u8(out)


def radius(sigma: float) -> int:
    return len(gaussian_taps(float(sigma))) // 2
