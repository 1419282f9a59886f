"""The two layer-commit rules the ported CLI needs from the document model
(paintfe_tpu.core.canvas); the document model itself is not yet ported."""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np

TILE = 64  # reference chunk size (canvas/defs.rs:7)
MAX_PIXELS = 256_000_000  # reference clamp (tiled_image.rs:14-26)


def clamp_dimensions(width: int, height: int) -> Tuple[int, int]:
    """TiledImage::new's overflow guard: >256 Mpix (or a zero dimension)
    clamps to 1x1 with a warning rather than erroring."""
    if width * height > MAX_PIXELS or width <= 0 or height <= 0:
        print(f"Canvas: dimensions {width}x{height} exceed 256M pixels, "
              "clamped to 1x1", file=sys.stderr)
        return 1, 1
    return width, height


def canonicalize_tiles(img: np.ndarray, tile: int = TILE) -> np.ndarray:
    """Zero out RGB of fully-transparent 64x64 tiles: the reference's
    sparse tile store drops fully-transparent chunks, so their color data
    reads back as zeros."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    out = img.copy()
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            blk = out[ty:ty + tile, tx:tx + tile]
            if not blk[..., 3].any():
                blk[...] = 0
    return out
