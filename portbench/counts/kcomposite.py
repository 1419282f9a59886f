"""K-composite (csrc/composite.cu): a fold of u8 RGBA layers with a blend
mode and an opacity each, from a transparent start.

f32 operations of a blend that runs (the top pixel is not clear, and is
not NORMAL-opaque at full opacity): 8 u8 -> f32 conversions and the
opacity product, then the Porter-Duff tail (7 for the alpha, 8 a channel)
and the mode's mixer a channel, counted on its cheapest branch with no
compare or select; XOR's tail is 5 for the alpha and 5 a channel, and
OVERWRITE's 4.  Bytes: every layer read once, the result written once."""

# f32 operations of each mode's channel mixer (core/blend.py), its cheapest
# branch; XOR (13) and OVERWRITE (14) have none
MIXER_OPS = {0: 0, 1: 1, 2: 4, 3: 2, 4: 4, 5: 4, 6: 4, 7: 3, 8: 2, 9: 2, 10: 4,
             11: 1, 12: 1, 15: 2, 16: 6, 17: 4, 18: 2, 19: 2, 20: 3, 21: 5,
             22: 4, 23: 1, 24: 1}


def blend_ops(mode: int) -> int:
    """f32 operations of one blend that runs, a pixel."""
    if mode == 13:
        return 9 + 5 + 3 * 5
    if mode == 14:
        return 9 + 4
    return 9 + 7 + 3 * 8 + 3 * MIXER_OPS[mode]


def ops(px: int, modes, runs_px) -> int:
    """runs_px[k]: pixels of layer k whose blend runs."""
    return sum(n * blend_ops(int(m)) for m, n in zip(modes, runs_px))


def nbytes(px: int, modes, runs_px) -> int:
    return (len(modes) + 1) * 4 * px
