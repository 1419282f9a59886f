"""The layer fold: u8 layers bottom-up over a transparent start, each
blended with its mode and opacity."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.blend import blend_u8


def apply(layers, modes, opacities, ft=torch.float32) -> torch.Tensor:
    """layers: u8 [N, H, W, 4] (or a sequence of [H, W, 4]), bottom first."""
    acc = torch.zeros_like(layers[0])
    for px, mode, opacity in zip(layers, modes, np.asarray(opacities, np.float32).tolist()):
        acc = blend_u8(acc, px, int(mode), opacity, ft)
    return acc
