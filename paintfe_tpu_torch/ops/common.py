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
