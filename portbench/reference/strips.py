"""Whole-width row strips with their clamped context, so that a reference
of a large image fits beside the program's state."""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import torch


def strips(fn: Callable, inputs, rows: int, context: int) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """(a, b, fn's rows a..b) over strips of `rows` rows of the [H, ...]
    inputs, each computed with up to `context` rows of the image above and
    below (clamped at its ends) and those rows dropped: equal to fn over
    the whole image where fn reads at most `context` rows beyond an output
    row and clamps at the image's edges."""
    h = inputs[0].shape[0]
    for a in range(0, h, rows):
        b = min(h, a + rows)
        lo, hi = max(0, a - context), min(h, b + context)
        out = fn(*(t[lo:hi] for t in inputs))
        yield a, b, out[a - lo:a - lo + (b - a)]


def by_strips(fn: Callable, inputs, rows: int, context: int) -> torch.Tensor:
    """The strips of `strips` joined: fn over the whole image."""
    return torch.cat([out for _, _, out in strips(fn, inputs, rows, context)])
