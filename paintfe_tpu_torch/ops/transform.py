"""Flips and rotations, exact permutations of u8 [..., H, W, 4] images, and
the displacement warp (paintfe_tpu.ops.transform's flips, rotations and
warp_displacement).

The permutations work on numpy arrays (the script host's pixel buffer) and
on torch tensors of any leading batch shape (the batch pipeline).
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


def warp_displacement(src, field) -> torch.Tensor:
    """Full-image displacement warp (transform.rs:1288-1345): output(x, y)
    = bilinear src(x - dx, y - dy), zero-padded corners, transparent
    outside the source.  src: u8 [Hs, Ws, 4] or [B, Hs, Ws, 4] (torch or
    numpy); field: (dx, dy) f32 [H, W, 2] (torch or numpy).  The gather is
    K-warp in mode "zero" on the card, its plain version on the CPU."""
    from paintfe_tpu_torch.ops.common import coord_grids
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src, np.uint8))
    if not isinstance(field, torch.Tensor):
        # round to f32 first: sx/sy arithmetic never runs in f64
        field = torch.from_numpy(np.asarray(field, np.float32))
    disp = field.to(device=src.device, dtype=torch.float32)
    h, w = disp.shape[:2]
    xs, ys = coord_grids(h, w, src.device)
    sx = xs - disp[..., 0]
    sy = ys - disp[..., 1]
    return gather_bilinear_u8(src, sx, sy, mode="zero")
