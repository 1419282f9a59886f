"""The comparison that decides `correct`: the largest difference, in u8
units, between what the timed path produced and the plain reference."""

from __future__ import annotations

import torch

# an exact comparison: the program's u8 semantics leave no room
LIMIT = 0
# what a comparison of nothing, or of a result of the wrong shape, reads:
# more than any two u8 values can differ
NOTHING = 256


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over u8 tensors of one shape (NOTHING where the
    shapes differ)."""
    if tuple(got.shape) != tuple(want.shape):
        return NOTHING
    got = got.to(want.device)
    return int((got.int() - want.int()).abs().max()) if want.numel() else 0
