"""Shared op helpers (paintfe_tpu.ops.common counterpart)."""

from __future__ import annotations

import torch


def masked(img: torch.Tensor, out: torch.Tensor, mask) -> torch.Tensor:
    """Selection-aware result merge: masked-out pixels keep the input
    (mask is u8 [H, W], 0 = unselected; None = everything selected)."""
    if mask is None:
        return out
    mask = torch.as_tensor(mask, device=img.device)
    return torch.where((mask > 0)[..., None], out, img)


def coord_grids(h: int, w: int, device="cpu"):
    """f32 pixel-coordinate grids (xs [H, W], ys [H, W])."""
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return xs, ys
