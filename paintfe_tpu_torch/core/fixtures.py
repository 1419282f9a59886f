"""Deterministic test-image generators (paintfe_tpu.core.fixtures counterpart,
host numpy, copied as it is).

Behavioral contract: tests/common/mod.rs:268-357 in the reference — exact
integer / f32-truncation math so the committed golden PNGs act as a
pixel-exact oracle for this framework too.
"""

from __future__ import annotations

import numpy as np


def test_gradient(w: int, h: int) -> np.ndarray:
    """Horizontal red->green gradient + vertical blue gradient, opaque.

    r = x*255/(w-1) (integer division), g = 255-r, b = y*255/(h-1).
    """
    x = np.arange(w, dtype=np.uint32)
    y = np.arange(h, dtype=np.uint32)
    r = (x * 255 // (w - 1)).astype(np.uint8) if w > 1 else np.full(w, 128, np.uint8)
    b = (y * 255 // (h - 1)).astype(np.uint8) if h > 1 else np.full(h, 128, np.uint8)
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = r[None, :]
    img[..., 1] = 255 - r[None, :]
    img[..., 2] = b[:, None]
    img[..., 3] = 255
    return img


def test_checkerboard(w: int, h: int, cell: int = 8) -> np.ndarray:
    """8-px checkerboard; cell (0,0) white."""
    cx = np.arange(w) // cell
    cy = np.arange(h) // cell
    white = (cx[None, :] + cy[:, None]) % 2 == 0
    v = np.where(white, 255, 0).astype(np.uint8)
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = v
    img[..., 1] = v
    img[..., 2] = v
    img[..., 3] = 255
    return img


def solid(w: int, h: int, color) -> np.ndarray:
    img = np.empty((h, w, 4), np.uint8)
    img[...] = np.asarray(color, np.uint8)
    return img


def transparent(w: int, h: int) -> np.ndarray:
    return np.zeros((h, w, 4), np.uint8)


def color_bands(w: int, h: int) -> np.ndarray:
    """8 vertical bands: R, G, B, C, M, Y, white, black."""
    colors = np.array(
        [
            [255, 0, 0, 255],
            [0, 255, 0, 255],
            [0, 0, 255, 255],
            [0, 255, 255, 255],
            [255, 0, 255, 255],
            [255, 255, 0, 255],
            [255, 255, 255, 255],
            [0, 0, 0, 255],
        ],
        np.uint8,
    )
    band = np.minimum(np.arange(w) * 8 // w, 7)
    img = np.empty((h, w, 4), np.uint8)
    img[:] = colors[band][None, :, :]
    return img


def blend_test_foreground(w: int, h: int) -> np.ndarray:
    """The translucent gradient FG used by the blend goldens.

    tests/visual_blend.rs:27-36: r=(x/w*255) trunc, g=(y/h*255) trunc, b=128,
    a=((x+y)/(w+h-2)*200+55) trunc — all f32 math truncated to u8.
    """
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    r = (xs / np.float32(w) * np.float32(255.0)).astype(np.uint8)
    g = (ys / np.float32(h) * np.float32(255.0)).astype(np.uint8)
    a_grid = (
        (xs[None, :] + ys[:, None]) / np.float32(w + h - 2) * np.float32(200.0)
        + np.float32(55.0)
    ).astype(np.uint8)
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0] = r[None, :]
    img[..., 1] = g[:, None]
    img[..., 2] = 128
    img[..., 3] = a_grid
    return img
