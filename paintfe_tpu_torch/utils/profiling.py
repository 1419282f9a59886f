"""Per-stage wall-clock timing for the CLI's --profile."""

from __future__ import annotations

import contextlib
import time
from typing import List, Tuple

import torch


class StageTimer:
    """Accumulates named stage durations.  On a CUDA device each stage ends
    with torch.cuda.synchronize(), so a time covers the device work the
    stage queued, not just its launch."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stages.append((name, time.perf_counter() - t0))

    def report(self) -> str:
        return "\n".join(f"  {name}: {dt * 1000:.1f} ms" for name, dt in self.stages)
