"""Per-stage wall-clock timing for the CLI's --profile, the profiler
trace of its --trace-dir, the program's spans and counters, and the
60-sample frame-time ring (the counterpart of
paintfe_tpu/utils/profiling.py).

Behavioral contract: the reference's observability surface (SURVEY §5) —
per-file wall clock in CLI verbose (cli.rs:164), FPS ring, script
elapsed_ms — with stage timers that wait for the device work a stage
queued.

Spans (`span`) are ranges of the torch profiler that is recording, if
one is: `--trace-dir`'s, or any caller's.  Each is a CPU operator on the
host thread that opened it, on the profiler's clock; its parent is the
span or range that encloses it on that thread.  Names are
`pfe.<layer>.<step>`.  Counters (`count`) are one registry for the
process, the kernels' launch counts among them
(utils/cuda_build.count_launch)."""

from __future__ import annotations

import contextlib
import os
import pathlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: a range named `name` in the torch profiler that
    is recording, and nothing (one flag read) when none is.  A
    _RecordFunctionFast range is a CPU operator: unlike
    torch.profiler.record_function, it is not mirrored onto the device
    timeline, so a span never reads as device work."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


# One lock for every count of the process, the kernels' launch counts
# included (utils/cuda_build.LAUNCH_LOCK is this lock): an add is a read,
# an add and a write, and the server's handler threads count at once.
COUNT_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}
_TRACED: Dict[str, int] = {}  # the counts made while a profiler recorded
_KERNELS: Dict[int, object] = {}  # id -> each kernel wrapper that has launched
LAUNCHES = "launches."  # a kernel's entry in counts(): LAUNCHES + its wrapper's name


def count(name: str, n: int = 1):
    """Add n to the process's counter `name`; while a torch profiler
    records, to its traced count too."""
    traced = _autograd_profiler._is_profiler_enabled
    with COUNT_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n
        if traced:
            _TRACED[name] = _TRACED.get(name, 0) + n


def count_launch(wrapper):
    """Add one to `wrapper.launches`, the one store of a kernel's launch
    count, which counts() reads as `launches.<name>`; while a torch
    profiler records, to the traced count of that name too."""
    traced = _autograd_profiler._is_profiler_enabled
    with COUNT_LOCK:
        wrapper.launches += 1
        _KERNELS[id(wrapper)] = wrapper
        if traced:
            name = LAUNCHES + _name(wrapper)
            _TRACED[name] = _TRACED.get(name, 0) + 1


def _name(wrapper) -> str:
    return getattr(wrapper, "__name__", type(wrapper).__name__)


def counts(traced: bool = False) -> Dict[str, int]:
    """Every counter of the process by name, each launched kernel's
    `.launches` among them; with traced=True, only what was counted while
    a torch profiler recorded.  That set is never reset: it is a
    profiler's window (one started after a warm-up) only in a process
    that runs one profiler."""
    with COUNT_LOCK:
        if traced:
            out = dict(_TRACED)
        else:
            out = dict(_COUNTS)
            out.update((LAUNCHES + _name(fn), fn.launches) for fn in _KERNELS.values())
    return dict(sorted(out.items()))


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
