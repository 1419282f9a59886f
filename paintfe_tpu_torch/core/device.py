"""Device residency: the layer buffer cache and the device-resident
composites (paintfe_tpu.core.device counterpart).

Behavioral contract: src/gpu/renderer.rs — per-layer texture cache
(`ensure_layer_texture` :324, `layer_is_current` :427), VRAM accounting
(:953-965), and the transfer-minimisation discipline (upload only what
changed; keep composites device-resident).  Here the "texture" is a torch
tensor on the card.  `composite_device` and `composite_dirty_rect` run the
same flatten as Canvas.composite (core/canvas.flatten: conceal masks, the
preview pre-blend, in-stream adjustment layers with the active-tile mask),
so the interactive path and the host flatten give identical bytes.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import torch

from paintfe_tpu_torch.core.canvas import flatten, tile_window, upload


class DeviceLayerCache:
    """Keeps layer buffers (pixels + mask) device-resident.

    Entries hold the host array they were uploaded from and revalidate by
    object identity: every op REPLACES ``layer.pixels``/``layer.mask`` with
    a fresh array and never writes one in place (an in-place writer would
    be served the stale upload).  ``generation`` is for callers that carry
    explicit counters: a changed counter uploads again even when the host
    array is the same object.  Because the entry pins the host array, a
    recycled ``id()`` can never alias a dead buffer.  A weakref finalizer
    evicts a layer's entries when the layer itself is garbage-collected
    (renderer.rs frees textures for dropped layers, :427-447)."""

    def __init__(self, device="cuda"):
        from paintfe_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        # (layer id, slot) -> (generation, host array, device tensor, weakref)
        self._cache: Dict[Tuple[int, str], Tuple[int, object, torch.Tensor, object]] = {}

    def get(self, layer, generation: Optional[int] = None,
            slot: str = "pixels") -> torch.Tensor:
        """Device tensor for `layer.pixels` (or `layer.mask` with
        slot="mask"), uploading only when stale: a new host array, or a
        `generation` other than the one the entry was uploaded at."""
        host = layer.pixels if slot == "pixels" else layer.mask
        key = (id(layer), slot)
        gen = generation if generation is not None else -1
        hit = self._cache.get(key)
        if hit is not None:
            old_gen, old_host, dev, _ = hit
            if old_host is host and (generation is None or old_gen == gen):
                return dev
        dev = upload(host, self.device)
        ref = weakref.ref(layer, lambda _, k=key, c=self._cache: c.pop(k, None))
        self._cache[key] = (gen, host, dev, ref)
        return dev

    def invalidate(self, layer):
        """Drop both of a layer's entries: its next get uploads again."""
        self._cache.pop((id(layer), "pixels"), None)
        self._cache.pop((id(layer), "mask"), None)

    def clear(self):
        self._cache.clear()

    def memory_bytes(self) -> int:
        """Device-memory accounting (renderer.rs:953-965 analogue)."""
        return sum(dev.numel() * dev.element_size() for _, _, dev, _ in self._cache.values())

    def resident_count(self) -> int:
        return len({lid for lid, _ in self._cache})


def composite_device(canvas, cache: DeviceLayerCache) -> torch.Tensor:
    """Composite with device-resident layers; returns a u8 [H, W, 4] tensor
    on the cache's device (no readback — the composite_to_gpu analogue,
    renderer.rs:805).  Bit-equal to Canvas.composite."""
    return flatten(canvas, cache.get, lambda layer: cache.get(layer, slot="mask"),
                   cache.device)


def composite_dirty_rect(canvas, cache: DeviceLayerCache, prev: torch.Tensor, rect):
    """Incremental recompute: re-composite only the dirty window and splice
    it into the previous device-resident composite, which is updated in
    place and returned.

    The reference's interactive loop recomposites and reads back only the
    dirty rect (canvas_state.rs:1511-1531 mark_dirty, renderer.rs:588).
    Here the flatten cuts the window of each cached layer (a contiguous copy
    handed to K-composite), uploads only the preview's window (grown to the
    64 px tile grid when an adjustment layer needs the active-tile mask) and
    reads that mask off the cached layers; the splice is a slice
    assignment.  When an adjustment layer applies, the window itself is
    grown to the 64 px tile grid: an edit that empties a tile (or fills an
    empty one) changes the active-tile mask for the whole tile, also
    outside the rect (ROADMAP C4).  Every pointwise stage of the full
    composite applies identically on the window, so the splice is
    bit-equal to a full recomposite.

    rect = (x0, y0, x1, y1) inclusive; `prev` is a u8 [H, W, 4] tensor on
    the cache's device.
    """
    x0, y0, x1, y1 = rect
    x0 = max(int(x0), 0)
    y0 = max(int(y0), 0)
    x1 = min(int(x1), canvas.width - 1)
    y1 = min(int(y1), canvas.height - 1)
    if x1 < x0 or y1 < y0:
        return prev
    bh, bw = y1 - y0 + 1, x1 - x0 + 1
    if any(l.content == "adjustment" and l.adjustment is not None
           for _, l in canvas.visible_layers()):
        y0, x0, bh, bw = tile_window(canvas.height, canvas.width, (y0, x0, bh, bw))
    prev[y0:y0 + bh, x0:x0 + bw] = flatten(
        canvas, cache.get, lambda layer: cache.get(layer, slot="mask"), cache.device,
        rect=(y0, x0, bh, bw))
    return prev
