"""Shared op helpers (paintfe_tpu.ops.common counterpart)."""

from __future__ import annotations

import numpy as np
import torch


def masked(img: torch.Tensor, out: torch.Tensor, mask) -> torch.Tensor:
    """Selection-aware result merge: masked-out pixels keep the input
    (mask is u8 [H, W], 0 = unselected; None = everything selected)."""
    if mask is None:
        return out
    mask = torch.as_tensor(mask, device=img.device)
    return torch.where((mask > 0)[..., None], out, img)


def as_image(img, device="cuda") -> torch.Tensor:
    """`img` as a tensor: a tensor stays where it is, a u8 array (numpy or
    array-like) goes to `device` (the card unless the caller passes "cpu";
    raises when no card is available)."""
    if isinstance(img, torch.Tensor):
        return img
    from paintfe_tpu_torch.utils.device import resolve_device

    host = torch.from_numpy(np.ascontiguousarray(img, np.uint8))
    return host.to(resolve_device(device))


def coord_grids(h: int, w: int, device="cuda"):
    """f32 pixel-coordinate grids (xs [H, W], ys [H, W]) on `device` (the
    card unless the caller passes "cpu")."""
    from paintfe_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return xs, ys


# Frames of one slice in by_frames: 4 frames of 3840x2160.  An f32 copy of
# a 4K RGBA frame is 133 MB, so an op holding several such temporaries
# over a 64-image --shard bucket would need tens of GB at once.
FRAME_SLICE_PX = 1 << 25


def by_frames(fn, *images: torch.Tensor, max_px: int = FRAME_SLICE_PX) -> torch.Tensor:
    """fn over u8 [..., H, W, C] tensors of one batch shape, in slices of
    whole frames, at most max(1, max_px // (H * W)) frames a slice, so the
    temporaries of a large batch never exist for all of it at once.  fn
    maps slices of `images` to a slice shaped like the first; no frame's
    result depends on the slicing."""
    img = images[0]
    h, w = img.shape[-3], img.shape[-2]
    if img.dim() == 3:
        return fn(*images)
    flat = [t.reshape((-1,) + tuple(t.shape[-3:])) for t in images]
    step = max(1, max_px // max(h * w, 1))
    n = flat[0].shape[0]
    if n <= step:
        return fn(*images)
    return torch.cat([fn(*(t[i:i + step] for t in flat)) for i in range(0, n, step)]
                     ).reshape(img.shape)


def pad_edges(t: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Edge-replicate pad of r entries on both sides of `dim`."""
    if r == 0:
        return t
    n = t.shape[dim]
    idx = torch.clamp(torch.arange(-r, n + r, device=t.device), 0, n - 1)
    return t.index_select(dim, idx)


def window_sums(t: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Integer sums of the 2r+1 window along `dim`, edges replicated (a
    difference of prefix sums: exact for integers, in any order)."""
    c = torch.cumsum(pad_edges(t, r, dim), dim=dim, dtype=torch.int32)
    n = t.shape[dim]
    hi = c.narrow(dim, 2 * r, n)
    lo = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c.narrow(dim, 0, n - 1)], dim)
    return hi - lo
