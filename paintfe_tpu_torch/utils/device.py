"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never a silent CPU run when the card is missing."""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.utils.profiling import count, span


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises RuntimeError for a CUDA device
    when no card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


def upload_shared(host: np.ndarray, device) -> torch.Tensor:
    """`host` as a tensor on `device`, for a cache that any host thread and
    any CUDA stream may read: on a CUDA device the copy has completed when
    this returns (the uploading stream is synchronized), so a kernel queued
    on another stream never reads a table still in flight.  Span
    `pfe.device.upload`; counter `device.uploads`."""
    with span("pfe.device.upload"):
        t = torch.from_numpy(np.array(host)).to(device)  # a copy: `host` may be read-only
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
    count("device.uploads")
    return t


def read_on_current_stream(t: torch.Tensor) -> torch.Tensor:
    """Mark a cached device tensor as read by the current stream: once the
    cache drops it, the caching allocator hands its memory out again only
    after the work queued on that stream is done (a no-op on the stream
    that uploaded it, and on the CPU)."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t
