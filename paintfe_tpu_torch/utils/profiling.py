"""Per-stage wall-clock timing for the CLI's --profile, the profiler
trace of its --trace-dir, and the 60-sample frame-time ring (the
counterpart of paintfe_tpu/utils/profiling.py).

Behavioral contract: the reference's observability surface (SURVEY §5) —
per-file wall clock in CLI verbose (cli.rs:164), FPS ring, script
elapsed_ms — with stage timers that wait for the device work a stage
queued."""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Dict, List, Optional, Tuple

import torch


class _StageHandle:
    """What a stage yields: `.result` names what the stage produced (the
    JAX timer's interface; the stage's synchronize already covers it)."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None


class StageTimer:
    """Accumulates named stage durations on `device` (the card unless the
    caller passes "cpu"; CUDA with no card raises).  On a CUDA device each
    stage ends with torch.cuda.synchronize(device), so a time covers the
    device work the stage queued, not just its launch."""

    def __init__(self, device="cuda"):
        from paintfe_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time one named stage.

        The JAX timer's interface: `block_on` (a zero-argument callable or
        a value) or the yielded handle's `.result` names what the stage
        produced, so code written against the JAX timer runs unchanged:

            with timer.stage("flatten") as h:
                h.result = flatten(img)

        Neither changes anything here: on a CUDA device the stage's
        synchronize already waits for all the work queued on the device,
        theirs included, and on the CPU torch's work is done when it
        returns."""
        handle = _StageHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stages.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        """Seconds by stage name, summed over the stage's runs."""
        out: Dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out

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


class FpsRing:
    """60-sample frame-time ring (canvas/view/core.rs:253-268)."""

    def __init__(self, size: int = 60):
        self.samples: List[float] = []
        self.size = size
        self._last: Optional[float] = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.size:
                self.samples.pop(0)
        self._last = now

    def fps(self) -> float:
        if not self.samples:
            return 0.0
        return len(self.samples) / sum(self.samples)
