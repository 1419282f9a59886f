"""The traced run: a torch.profiler window over the requests, read into a
device timeline (kernels, copies and fills, by card) and the benchmark's
own request spans, on one clock."""

from __future__ import annotations

import contextlib
import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import stats

SPAN = "portbench.request"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    device: int
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def is_copy(self) -> bool:
        return self.name.startswith("Memcpy")


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric reads: `ops`, every kernel, copy and fill on
    the cards; `spans`, each request's [start, end] on the host, in order;
    `host_ops`, (name, start, end) of what the host thread of the requests
    ran (operators and runtime calls), for naming idle gaps; `devices`,
    the cards the cell uses.  Times are ns on the profiler's clock."""

    ops: List[DeviceOp]
    spans: List[Tuple[int, int]]
    host_ops: List[Tuple[str, int, int]]
    devices: List[int]

    @property
    def window(self) -> Tuple[int, int]:
        return self.spans[0][0], self.spans[-1][1]

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    def in_window(self) -> List[DeviceOp]:
        lo, hi = self.window
        return [op for op in self.ops if op.end_ns > lo and op.start_ns < hi]

    def busy(self, device: Optional[int] = None) -> List[Tuple[int, int]]:
        """Merged busy intervals of one card (every card where None)."""
        return stats.merge((op.start_ns, op.end_ns) for op in self.ops
                           if device is None or op.device == device)

    def busy_s(self, device: int) -> float:
        lo, hi = self.window
        return stats.covered(self.busy(device), lo, hi) / 1e9

    def idle_share(self, device: int) -> float:
        lo, hi = self.window
        return stats.idle_share(self.busy(device), lo, hi)

    def host_label(self, t: int) -> str:
        """What the host thread was doing at t: the request span or the
        loop between requests, and the innermost operator or runtime call."""
        inside = any(a <= t <= b for a, b in self.spans)
        where = "request" if inside else "between_requests"
        best = None
        for name, a, b in self.host_ops:
            if a <= t <= b and (best is None or a >= best[1]):
                best = (name, a)
        return f"{where}:{best[0] if best else 'host'}"


def short_name(name: str, width: int = 64) -> str:
    """A device op's name as the breakdown lists it."""
    return re.sub(r"[^A-Za-z0-9_:.]", "_", name)[:width]


def breakdown(view: TraceView, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time in the window (summed by name over
    the cards) and the longest idle gaps of the first card, each named by
    what the host was doing at its middle."""
    by_name: Dict[str, float] = defaultdict(float)
    for op in view.in_window():
        by_name[short_name(op.name)] += op.seconds
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = view.window
    bare = sorted(stats.gaps(view.busy(view.devices[0]), lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[view.host_label((a + b) // 2), (b - a) / 1e9] for a, b in bare]}


def _kind(e) -> str:
    """An event's kind: "device" (a kernel, copy or fill on a card), "span"
    (a request span of ours on the host), "host" (an operator or runtime
    call on the host) or "" (our spans on the device timeline, the
    runtime's sync records)."""
    name = e.name()
    if e.device_type() == _cuda_type():
        return "" if name.startswith("portbench.") or _SYNC.search(name) else "device"
    return "span" if name == SPAN else "host"


_SYNC = re.compile(r"\bSync\b|Wait Event|Event Record")


def _cuda_type():
    import torch

    return torch.autograd.DeviceType.CUDA


def read(prof, devices: Sequence[int]) -> TraceView:
    """The profiler's raw events as a TraceView."""
    ops, spans, host = [], [], []
    span_threads = set()
    events = [(e, _kind(e)) for e in prof.profiler.kineto_results.events()]
    for e, kind in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if kind == "device":
            ops.append(DeviceOp(e.device_index(), e.name(), a, b))
        elif kind == "span":
            spans.append((a, b))
            span_threads.add(e.start_thread_id())
    for e, kind in events:
        if kind == "host" and e.start_thread_id() in span_threads:
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    spans.sort()
    return TraceView(ops=ops, spans=spans, host_ops=host, devices=list(devices))


class Tracer:
    """A profiler over the window when `on`, with a span around each
    request; a tracer that is off records nothing and costs nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def start(self):
        if self.on:
            import torch

            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()

    def span(self):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN)

    def stop(self, devices: Sequence[int]) -> Optional[TraceView]:
        if not self.on:
            return None
        self.prof.stop()
        return read(self.prof, devices)
