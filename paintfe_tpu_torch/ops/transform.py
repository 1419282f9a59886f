"""Flips and rotations, exact permutations of u8 [..., H, W, 4] images,
the image-crate resize, the canvas resize and the displacement warp
(paintfe_tpu.ops.transform's flips, rotations, resize, resize_canvas and
warp_displacement).

The permutations work on numpy arrays (the script host's pixel buffer) and
on torch tensors of any leading batch shape (the batch pipeline).  Resize
and resize_canvas are host numpy in the JAX package and are copied here as
host numpy, so they come out identical to it.
"""

from __future__ import annotations

import numpy as np
import torch

f32 = np.float32


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


# ---------------------------------------------------------------------------
# image-crate-compatible separable resize
# ---------------------------------------------------------------------------


def _box_kernel(x):
    return np.ones_like(x)


def _triangle_kernel(x):
    a = np.abs(x)
    return np.where(a < 1.0, f32(1.0) - a, f32(0.0))


def _catmullrom_kernel(x):
    # cubic BC with b=0, c=0.5 (image crate's CatmullRom)
    a = np.abs(x).astype(f32)
    b, c = f32(0.0), f32(0.5)
    k1 = (f32(12.0) - f32(9.0) * b - f32(6.0) * c) * a**3 + (
        f32(-18.0) + f32(12.0) * b + f32(6.0) * c
    ) * a**2 + (f32(6.0) - f32(2.0) * b)
    k2 = (-b - f32(6.0) * c) * a**3 + (f32(6.0) * b + f32(30.0) * c) * a**2 + (
        f32(-12.0) * b - f32(48.0) * c
    ) * a + (f32(8.0) * b + f32(24.0) * c)
    k = np.where(a < 1.0, k1, np.where(a < 2.0, k2, f32(0.0)))
    return (k / f32(6.0)).astype(f32)


def _sinc(t):
    t = t.astype(f32)
    a = t * f32(np.pi)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.sin(a, dtype=f32) / a
    return np.where(t == 0.0, f32(1.0), v).astype(f32)


def _lanczos3_kernel(x):
    a = np.abs(x).astype(f32)
    return np.where(a < 3.0, _sinc(x) * _sinc(x / f32(3.0)), f32(0.0)).astype(f32)


_FILTERS = {
    "nearest": (_box_kernel, 0.0),
    "bilinear": (_triangle_kernel, 1.0),
    "bicubic": (_catmullrom_kernel, 2.0),
    "lanczos3": (_lanczos3_kernel, 3.0),
}


def _sample_axis(data: np.ndarray, new_len: int, kernel, support: float) -> np.ndarray:
    """One resampling pass along axis 0 (f32 in, f32 out), mirroring the
    image crate's vertical_sample loop structure."""
    old_len = data.shape[0]
    ratio = f32(old_len) / f32(new_len)
    sratio = ratio if ratio >= 1.0 else f32(1.0)
    src_support = f32(support) * sratio

    out = np.zeros((new_len,) + data.shape[1:], f32)
    for o in range(new_len):
        inputx = (f32(o) + f32(0.5)) * ratio
        left = int(np.floor(f32(inputx - src_support)))
        left = min(max(left, 0), old_len - 1)
        right = int(np.ceil(f32(inputx + src_support)))
        right = min(max(right, left + 1), old_len)
        center = f32(inputx - f32(0.5))
        idx = np.arange(left, right)
        ws = kernel(((idx.astype(f32) - center) / sratio).astype(f32)).astype(f32)
        total = f32(0.0)
        for wv in ws:  # sequential f32 sum, matching the Rust loop
            total = f32(total + wv)
        ws = (ws / total).astype(f32)
        # accumulate in tap order (f32)
        acc = np.zeros(data.shape[1:], f32)
        for k, i in enumerate(idx):
            acc += data[i] * ws[k]
        out[o] = acc
    return out


def resize(img, new_w: int, new_h: int, interpolation: str = "bilinear") -> np.ndarray:
    """image::imageops::resize parity: vertical pass, then horizontal, f32
    intermediate, clamp + round-half-away to u8 at the end."""
    img = np.asarray(img)
    kernel, support = _FILTERS[interpolation]
    data = img.astype(f32)
    tmp = _sample_axis(data, new_h, kernel, support)  # vertical
    out = _sample_axis(np.swapaxes(tmp, 0, 1), new_w, kernel, support)
    out = np.swapaxes(out, 0, 1)
    return np.clip(np.floor(out + f32(0.5)), 0, 255).astype(np.uint8)


def resize_canvas(img, new_w: int, new_h: int, anchor=(0, 0), fill=(0, 0, 0, 0)):
    """Anchor-offset copy onto fill color (transform.rs:382-464).
    anchor components: 0=start, 1=center, 2=end."""
    img = np.asarray(img)
    old_h, old_w = img.shape[:2]
    ax, ay = anchor
    # Rust i32 division truncates toward zero; Python // floors — match Rust.
    offset_x = (0 if ax == 0
                else int((new_w - old_w) / 2) if ax == 1 else new_w - old_w)
    offset_y = (0 if ay == 0
                else int((new_h - old_h) / 2) if ay == 1 else new_h - old_h)
    out = np.empty((new_h, new_w, 4), np.uint8)
    out[...] = np.asarray(fill, np.uint8)
    sx0 = max(-offset_x, 0)
    sy0 = max(-offset_y, 0)
    dx0 = max(offset_x, 0)
    dy0 = max(offset_y, 0)
    cw = min(old_w - sx0, new_w - dx0)
    ch = min(old_h - sy0, new_h - dy0)
    if cw > 0 and ch > 0:
        out[dy0 : dy0 + ch, dx0 : dx0 + cw] = img[sy0 : sy0 + ch, sx0 : sx0 + cw]
    return out
