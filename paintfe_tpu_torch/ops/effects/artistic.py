"""Artistic effects: ink (Sobel) and oil painting (modal intensity bin)
(paintfe_tpu.ops.effects.artistic counterpart; color_filter waits for
ROADMAP A6).

Behavioral contract: src/ops/effects/artistic.rs — ink_core (:31-101),
oil_painting_core (:123-218).  Both are IEEE-basic and byte-equal to the
JAX package: ink's Sobel sums run in f32 in the reference's expression
order with a correctly rounded sqrt and divide; oil painting is integer
window sums per intensity level, the modal level taken with a strict >
(the first maximum wins, the reference's tie order).
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import by_frames, pad_edges, window_sums
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32


def ink(img: torch.Tensor, edge_strength: float, threshold: float,
        mask=None) -> torch.Tensor:
    """Sobel on BT.709 luma -> black where the edge exceeds the threshold,
    white elsewhere (artistic.rs:31-101), of u8 [..., H, W, 4]; alpha
    kept."""
    es = float(f32(edge_strength))
    thresh = float(f32(threshold))

    def run(x):
        h, w = x.shape[-3], x.shape[-2]
        src = x.float()
        lum = 0.2126 * src[..., 0] + 0.7152 * src[..., 1] + 0.0722 * src[..., 2]
        lpad = pad_edges(pad_edges(lum, 1, -2), 1, -1)

        def lm(dx, dy):
            return lpad[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

        gx = (-lm(-1, -1) - 2.0 * lm(-1, 0) - lm(-1, 1)
              + lm(1, -1) + 2.0 * lm(1, 0) + lm(1, 1))
        gy = (-lm(-1, -1) - 2.0 * lm(0, -1) - lm(1, -1)
              + lm(-1, 1) + 2.0 * lm(0, 1) + lm(1, 1))
        edge = ieee_div(sqrt_f32(gx * gx + gy * gy) * es, 100.0)
        val = torch.where(edge > thresh, 0, 255).to(torch.uint8)
        return torch.stack([val, val, val, x[..., 3]], dim=-1)

    return _masked(img, by_frames(run, img), mask)


def oil_painting(img: torch.Tensor, radius: int, levels: int, mask=None) -> torch.Tensor:
    """Mean colour of the modal intensity bin of the (2r+1)^2 window
    (artistic.rs:123-218), of u8 [..., H, W, 4], r clipped to [1, 10] and
    the levels to [2, 64]; alpha kept."""
    r = int(np.clip(radius, 1, 10))
    n_levels = int(np.clip(levels, 2, 64))

    def box(m):  # [..., H, W] integer -> window sums, edges replicated
        return window_sums(window_sums(m, r, -1), r, -2)

    def run(x):
        src = x.int()
        inten = torch.clamp((src[..., 0] + src[..., 1] + src[..., 2]) // 3
                            * n_levels // 256, max=n_levels - 1)
        best_cnt = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
        best = torch.zeros(x.shape[:-1] + (3,), dtype=torch.int32, device=x.device)
        for lvl in range(n_levels):
            ind = (inten == lvl).int()
            cnt = box(ind)
            sums = torch.stack([box(ind * src[..., c]) for c in range(3)], dim=-1)
            take = cnt > best_cnt
            best_cnt = torch.where(take, cnt, best_cnt)
            best = torch.where(take[..., None], sums, best)
        rgb = (best // torch.clamp(best_cnt, min=1)[..., None]).to(torch.uint8)
        return torch.cat([rgb, x[..., 3:4]], dim=-1)

    return _masked(img, by_frames(run, img), mask)
