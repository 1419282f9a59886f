"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never a silent CPU run when the card is missing."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises RuntimeError for a CUDA device
    when no card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev
