"""A kernel's share of its roofline over a traced window: the least time
its calls could take on the card's published peaks, over the device time
its launches took."""

from __future__ import annotations

import importlib
import re
from typing import Optional, Sequence

from portbench import peaks


def kernel_pattern(names: Sequence[str]) -> re.Pattern:
    """Device op names that hold one of the kernel names as a whole word."""
    return re.compile(r"\b(?:" + "|".join(map(re.escape, names)) + r")\b")


def share(run, kernels: Sequence[str], counts: str) -> Optional[float]:
    """100 x the least time of every request's work for counts/<counts>.py
    over the traced time of the launches named `kernels`; None where the
    trace holds no such launch or the requests no such work."""
    view = run.trace
    if view is None or not view.spans:
        return None
    pat = kernel_pattern(kernels)
    spent = sum(op.seconds for op in view.in_window() if pat.search(op.name))
    mod = importlib.import_module(f"portbench.counts.{counts}")
    least = sum(peaks.least_s(mod.ops(**r.work[counts]), mod.nbytes(**r.work[counts]))
                for r in run.records if counts in r.work)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
