"""What the entries' faults share: a fault breaks the timed path
underneath, and the comparison that decides `correct` has to see it."""

from __future__ import annotations

import torch


def flip_one_byte(out: torch.Tensor) -> torch.Tensor:
    """A copy of `out` with one byte, a third of the way in, altered."""
    out = out.clone()
    out.view(-1)[out.numel() // 3] ^= 1
    return out


def after(monkeypatch, module, name: str, then) -> None:
    """module.name replaced by a call of the real one whose result goes
    through `then`."""
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: then(real(*a, **k)))
