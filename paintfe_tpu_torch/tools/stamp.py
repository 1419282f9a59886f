"""What every stamp of the painting tools shares: the selection's window on
the target's device, and the target's window written back in one copy.

A stroke uploads its selection once (`resident`) and each stamp cuts its
window there; a host selection given to a single stamp uploads only that
window.  Nothing here reads a value back from the device, so a stroke of
thousands of stamps queues its work without waiting on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def resident(array, device) -> Optional[torch.Tensor]:
    """`array` (a selection, a tip mask, indices: a host array or a tensor;
    None stays None) as a tensor on `device`, a host array uploaded without
    waiting for the stream."""
    if array is None or isinstance(array, torch.Tensor) and array.device == device:
        return array
    if isinstance(array, torch.Tensor):
        return array.to(device)
    return torch.from_numpy(np.ascontiguousarray(array)).to(device, non_blocking=True)


def selected(selection, y0: int, y1: int, x0: int, x1: int, device) -> Optional[torch.Tensor]:
    """bool [y1 - y0, x1 - x0]: the selection's window != 0 on `device`
    (None when there is no selection)."""
    if selection is None:
        return None
    return resident(selection[y0:y1, x0:x1], device) != 0


def check_target(img) -> torch.Tensor:
    """A stamp's target: a u8 [H, W, 4] tensor, written in place where it
    lies."""
    if not isinstance(img, torch.Tensor) or img.dtype != torch.uint8 or img.dim() != 3:
        raise TypeError("a stamp target is a u8 [H, W, 4] torch tensor, written in place "
                        "on its device")
    return img
