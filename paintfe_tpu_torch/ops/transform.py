"""Flips and 180-degree rotation: exact permutations of u8 [..., H, W, 4]
images (paintfe_tpu.ops.transform's flips and rotations).

They work on numpy arrays (the script host's pixel buffer) and on torch
tensors of any leading batch shape (the batch pipeline).
"""

from __future__ import annotations

import numpy as np
import torch


def _flip(img, axes):
    if isinstance(img, torch.Tensor):
        return torch.flip(img, dims=[a - 3 for a in axes])
    img = np.asarray(img)
    return np.ascontiguousarray(np.flip(img, axis=[img.ndim + a - 3 for a in axes]))


def flip_horizontal(img):
    return _flip(img, (1,))


def flip_vertical(img):
    return _flip(img, (0,))


def rotate_180(img):
    return _flip(img, (0, 1))


def rotate_90cw(img):
    if isinstance(img, torch.Tensor):
        return torch.rot90(img, k=-1, dims=(-3, -2)).contiguous()
    return np.ascontiguousarray(np.rot90(np.asarray(img), k=-1, axes=(-3, -2)))


def rotate_90ccw(img):
    if isinstance(img, torch.Tensor):
        return torch.rot90(img, k=1, dims=(-3, -2)).contiguous()
    return np.ascontiguousarray(np.rot90(np.asarray(img), k=1, axes=(-3, -2)))
