"""The program's own spans and counters in a traced run, for the
per-layer metrics that read them.

The program (paintfe_tpu_torch/utils/profiling.py) opens spans named
`pfe.<layer>.<step>` on the host thread while a torch profiler records;
they reach a TraceView as host operators.  Its counters, counted while the
profiler recorded, are `profiling.counts(traced=True)`: the run starts its
profiler after the warm-up, so they are the window's.  A program without
these spans or counters reads 0 attributed idle time and 0 counts."""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple

from portbench import stats

PREFIX = "pfe."
# the layer that the idle time under a span is charged to, by the span's
# name; a metric may pass a table of its own ({layer: prefixes})
LAYERS = {"spatial": ("pfe.spatial.",),
          "kernels": ("pfe.kchain.", "pfe.kcomposite.", "pfe.device.")}
OUTSIDE = "outside"  # no span of these layers open: the caller's own code


def layer_of(name: str, layers=LAYERS) -> str:
    for layer, prefixes in layers.items():
        if name.startswith(prefixes):
            return layer
    return OUTSIDE


def innermost(host_ops) -> List[Tuple[int, int, str]]:
    """(start, end, name) pieces of time, sorted and disjoint, each under
    the innermost `pfe.` span open then; the spans nest on their thread,
    and time under no such span is in no piece."""
    spans = sorted(((a, b, n) for n, a, b in host_ops if n.startswith(PREFIX) and b > a),
                   key=lambda s: (s[0], -s[1]))
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []   # (end, name), the innermost last
    t = -math.inf

    def advance(to):
        nonlocal t
        while stack and stack[-1][0] <= to:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end
        if stack and to > t:
            out.append((t, to, stack[-1][1]))
        t = max(t, to)

    for a, b, name in spans:
        advance(a)
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    advance(math.inf)
    return out


def idle_by_layer(view, layers=LAYERS) -> Optional[Dict[str, float]]:
    """The first card's idle time inside the request spans, split at the
    `pfe.` spans' boundaries and charged to the layer of `layers` that the
    innermost one open names (OUTSIDE where none is open, or the table
    names none), in ns summed over the requests; None
    where the trace holds no requests or no device work."""
    if view is None or not view.spans or not view.ops:
        return None
    pieces = innermost(view.host_ops)
    starts = [a for a, _, _ in pieces]
    busy = view.busy(view.devices[0])
    out = dict.fromkeys((*layers, OUTSIDE), 0.0)
    for lo, hi in view.spans:
        for g0, g1 in stats.gaps(busy, lo, hi):
            charged = 0.0
            k = max(bisect.bisect_right(starts, g0) - 1, 0)
            while k < len(pieces) and pieces[k][0] < g1:
                a, b, name = pieces[k]
                part = max(0.0, min(b, g1) - max(a, g0))
                out[layer_of(name, layers)] += part
                charged += part
                k += 1
            out[OUTSIDE] += (g1 - g0) - charged
    return out


def idle_ms_per_edit(run, layer: str, layers=LAYERS) -> Optional[float]:
    """The mean over the window's requests of the idle time charged to
    `layer` of `layers`, in ms."""
    split = idle_by_layer(run.trace, layers)
    return None if split is None else split[layer] / len(run.trace.spans) / 1e6


def traced_counts() -> Dict[str, int]:
    """The program's counts made while the profiler recorded; {} where the
    program keeps none."""
    try:
        from paintfe_tpu_torch.utils import profiling
    except ImportError:
        return {}
    counts = getattr(profiling, "counts", None)
    return counts(traced=True) if counts is not None else {}


def counted_per_edit(run, prefix: str) -> Optional[float]:
    """The sum of the traced counters whose names start with `prefix`, over
    the window's requests; None where there is no trace."""
    view = run.trace
    if view is None or not view.spans:
        return None
    total = sum(n for name, n in traced_counts().items() if name.startswith(prefix))
    return total / len(view.spans)
