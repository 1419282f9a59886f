"""K-chain (csrc/fused_chain.cu): Gaussian blur, brightness/contrast,
levels, sepia and a soft-light flatten of an overlay over u8 RGBA.

f32 operations: the blur's two passes of `taps` multiplies and adds on
four channels, 36 a pixel for the tail, and 55 more a pixel where the
overlay is not clear (its soft-light Porter-Duff).  Bytes: the image and
the overlay read once, the result written once."""


def ops(px: int, taps: int, overlay_px: int) -> int:
    return 4 * taps * 4 * px + 36 * px + 55 * overlay_px


def nbytes(px: int, taps: int, overlay_px: int) -> int:
    return 3 * 4 * px
