"""Per-stage wall-clock timing for the CLI's --profile, and the profiler
trace of its --trace-dir."""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import List, Optional, Tuple

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


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Wrap a region in a torch.profiler trace (host and CUDA activity)
    when a log dir is given, and write it there as a Chrome trace on exit,
    an exception's included (the counterpart of paintfe_tpu's jax_trace).
    Without a log dir it does nothing."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))
