"""Colour-space helpers (paintfe_tpu.core.colorspace counterpart; for now
the BT.709 luma that halftone needs)."""

from __future__ import annotations


def luma_bt709(r, g, b):
    """BT.709 luminance on 0..255-scaled f32 channels (order-preserving
    sum; each coefficient rounds to f32 against an f32 tensor)."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b
