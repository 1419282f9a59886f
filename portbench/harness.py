"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json names its configuration (configs/<config>.json) and its
traffic (traffic/<traffic>.json); the traffic names the entry of the
program it drives (entries/<entry>.py); each metric is read by
metrics/<metric>.py.  An entry module has

    setup(cell) -> state           inputs made from the seed, the program's objects
    call(state, i) -> (out, info)  request i: its output, and info with
                                   "pixels" and "work" (kernel -> the
                                   shapes counts/<kernel>.py takes)
    check(state, kept) -> {name: (value, limit)}
                                   the plain reference over the kept requests
                                   [(i, out, info)], once the window has closed

and a metric module has `read(run) -> float | None` (None: nothing to read).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import random
import re
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

from portbench import trace as tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
CSRC = ROOT / "paintfe_tpu_torch" / "csrc"
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "paintfe_tpu")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


class CellError(Exception):
    """A cell that BENCHMARK.json does not hold."""


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded in the run."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    devices: list       # torch.device entries, the cell's cards in order
    seed: int
    control: bool = False   # the reference in bfloat16 in the program's place


@dataclasses.dataclass
class Record:
    latency_ms: float
    pixels: int
    work: dict


@dataclasses.dataclass
class Run:
    """What the metrics read."""
    records: List[Record]
    window_s: float
    setup_s: float
    trace: Optional[tracing.TraceView]


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, loaded from its file (a name may hold
    dots or dashes)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    if spec.name in sys.modules:
        return sys.modules[spec.name]
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, name: str):
    """The cell's BENCHMARK.json entry, configuration and traffic, by name."""
    specs = [w for w in bench["workloads"] if w["name"] == name]
    if not specs:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    spec = specs[0]
    config = json.loads((BENCH / "configs" / f"{spec['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{spec['traffic']}.json").read_text())
    return spec, config, traffic


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric belongs on this cell's line: listed for it, or, for
    an end-to-end metric without a list, everywhere.  A per-layer metric
    (one that `moves` another) has to list its cells."""
    if "moves" in metric and "workloads" not in metric:
        raise CellError(f"per-layer metric {metric['name']!r} lists no workloads")
    return cell in metric.get("workloads", (cell,))


def csrc_kernels(csrc: pathlib.Path = CSRC) -> frozenset:
    """The names of the program's hand-written CUDA kernels (__global__)."""
    return frozenset(n for p in csrc.glob("*.cu") for n in _GLOBAL.findall(p.read_text()))


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Reservoir:
    """A uniform sample of k of the requests offered, drawn from the seed,
    holding no more than k outputs at a time."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items, self.seen = [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def _sync(devices):
    import torch

    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class _Latency:
    """One request's time: CUDA events on the first card's stream around
    the call, read after the synchronise (the host clock's wake-up jitter
    stays out of a request of a few ms); the host clock on a CPU."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.current_stream(device)
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def begin(self):
        self.t0 = time.perf_counter()
        if self.cuda:
            self.a.record(self.stream)

    def end(self):
        if self.cuda:
            self.b.record(self.stream)

    def ms(self, t1: float) -> float:
        return self.a.elapsed_time(self.b) if self.cuda else (t1 - self.t0) * 1e3


def window(entry, state, cell: Cell, seconds: float, tracer, reservoir: Reservoir):
    """Closed loop, one caller: request after request until `seconds` have
    passed, each whole; returns (records, failed, window seconds)."""
    records, failed, i = [], 0, 0
    clock = _Latency(cell.devices[0])
    start = time.perf_counter()
    while True:
        clock.begin()
        try:
            with tracer.span():
                out, info = entry.call(state, i)
                clock.end()
                _sync(cell.devices)
        except Exception:  # a failed request is counted against those attempted
            traceback.print_exc()
            failed += 1
            _sync(cell.devices)
            out = None
        t1 = time.perf_counter()
        if out is not None:
            records.append(Record(clock.ms(t1), info["pixels"], info["work"]))
            reservoir.offer((i, out, info))
        del out
        i += 1
        if t1 - start >= seconds:
            return records, failed, t1 - start


def execute(name: str, seed: int, seconds: float, trace: bool, devices, *, t0: float,
            control: bool = False, overrides: Optional[Dict[str, Any]] = None) -> dict:
    """Run cell `name` once on `devices` (torch.device entries, one a card
    the cell asks for) and return the result line as a dict.  `overrides`
    replaces configuration keys (the tests' small sizes); `t0` is the
    process's start on the host clock."""
    import torch

    bench = benchmark()
    _, config, traffic = resolve(bench, name)
    config = {**config, **(overrides or {})}
    cell = Cell(name, config, traffic, list(devices), seed, control)
    entry = load_module("entries", traffic["entry"])
    cuda = [d for d in cell.devices if d.type == "cuda"]  # peaks count from the process's start

    state = entry.setup(cell)
    for k in range(traffic.get("warmup", 1)):  # every shape of the window, before it
        entry.call(state, -1 - k)
    _sync(cell.devices)
    tracer = tracing.Tracer(trace)
    tracer.start()
    setup_s = time.perf_counter() - t0
    reservoir = Reservoir(traffic["samples"], seed)
    records, failed, window_s = window(entry, state, cell, seconds, tracer, reservoir)
    _sync(cell.devices)
    view = tracer.stop(sorted({d.index for d in cuda}))
    peak = max((torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(cuda)), default=0)

    # the outputs not kept go, and the allocator's cache, before the reference runs
    kept = list(reservoir.items)
    del reservoir
    if cuda:
        torch.cuda.empty_cache()
    checks = entry.check(state, kept)
    del kept

    run = Run(records, window_s, setup_s, view)
    metrics, missing = {}, []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not applies(m, name):
            continue
        value = load_module("metrics", m["name"]).read(run)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
              "count": len(dict.fromkeys(cell.devices)), "memory_peak_bytes": peak}
    if view is not None and view.spans:
        device["busy_s"] = sum(view.busy_s(d) for d in view.devices) / max(len(view.devices), 1)
        device["window_s"] = view.window_s
    correct = (failed == 0 and bool(records)
               and all(value <= limit for value, limit in checks.values()))
    result = {"correct": correct, "attempted": len(records) + failed, "failed": failed,
              "metrics": metrics, "device": device}
    if view is not None and view.spans and view.ops:
        result["breakdown"] = tracing.breakdown(view)
    if missing:
        result["missing"] = missing
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    bad = forbidden_modules()  # last: after the reference and the metrics have run
    if bad:
        raise ForbiddenModules(f"modules loaded that a run may not load: {', '.join(bad)}")
    return result
