"""Canvas-level (all-layer) transforms with selection awareness
(paintfe_tpu.ops.canvas_transform counterpart).

Behavioral contract: src/ops/transform.rs:62-344 — whole-canvas flips /
90-degree rotates apply to every layer (swapping canvas dims for 90s);
when a *partial* selection exists they instead cut out the selection bbox,
transform the cutout + mask, and paste the result back centered on the
original bbox (try_transform_selected_region, :188-344).  Also canvas-wide
resize, canvas-resize with anchor, flatten, arbitrary-angle rotate, and the
LOD composite.

Flips, 90-degree rotations, resizes and crops are host numpy, as in the
JAX package.  rotate_canvas_arbitrary maps on `device` and gathers every
layer and mask of one shape in one batched call (K-warp for bilinear, one
launch), and composite_viewport / composite_lod flatten there (K-composite);
`device` is the card unless the caller passes "cpu".  Every op assigns new
pixel and mask arrays and never writes into the ones a layer holds.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
import torch

from paintfe_tpu_torch.core.canvas import Canvas, upload
from paintfe_tpu_torch.ops import transform as tfm
from paintfe_tpu_torch.utils.device import resolve_device


class CanvasTransform(enum.Enum):
    FLIP_H = "flip_h"
    FLIP_V = "flip_v"
    ROT90_CW = "rot90cw"
    ROT90_CCW = "rot90ccw"
    ROT180 = "rot180"


_RGBA_FNS = {
    CanvasTransform.FLIP_H: tfm.flip_horizontal,
    CanvasTransform.FLIP_V: tfm.flip_vertical,
    CanvasTransform.ROT90_CW: tfm.rotate_90cw,
    CanvasTransform.ROT90_CCW: tfm.rotate_90ccw,
    CanvasTransform.ROT180: tfm.rotate_180,
}


def _selection_bounds(mask: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def _floor_div2(v: int) -> int:
    return v // 2 if v >= 0 else -((-v + 1) // 2)


def _try_transform_selected_region(canvas: Canvas, transform: CanvasTransform) -> bool:
    """Partial selection: transform only the selected cutout, paste back
    centered on the original bbox (transform.rs:188-344)."""
    if canvas.selection is None:
        return False
    mask = canvas.selection
    if (mask > 0).all():
        return False
    bounds = _selection_bounds(mask)
    if bounds is None:
        return False
    min_x, min_y, max_x, max_y = bounds
    region_w = max_x - min_x + 1
    region_h = max_y - min_y + 1
    region_mask = mask[min_y : max_y + 1, min_x : max_x + 1].copy()

    fn = _RGBA_FNS[transform]
    # grayscale region transforms use the same permutations
    tmask = fn(region_mask[..., None])[..., 0]
    th, tw = tmask.shape
    dst_min_x = min_x + _floor_div2(region_w - tw)
    dst_min_y = min_y + _floor_div2(region_h - th)

    for layer in canvas.layers:
        cutout = np.zeros((region_h, region_w, 4), np.uint8)
        sel = region_mask > 0
        # fresh array up front: the slice writes below must not mutate the
        # buffer the device-layer cache revalidates by identity
        layer.pixels = layer.pixels.copy()
        src_region = layer.pixels[min_y : max_y + 1, min_x : max_x + 1]
        cutout[sel] = src_region[sel]
        src_region[sel] = 0  # clear the original selected pixels

        tcut = fn(cutout)
        # paste the transformed cutout where the transformed mask covers
        x0 = max(dst_min_x, 0)
        y0 = max(dst_min_y, 0)
        x1 = min(dst_min_x + tw, canvas.width)
        y1 = min(dst_min_y + th, canvas.height)
        if x1 <= x0 or y1 <= y0:
            continue
        sx0, sy0 = x0 - dst_min_x, y0 - dst_min_y
        dst = layer.pixels[y0:y1, x0:x1]
        msk = tmask[sy0 : sy0 + (y1 - y0), sx0 : sx0 + (x1 - x0)] > 0
        src = tcut[sy0 : sy0 + (y1 - y0), sx0 : sx0 + (x1 - x0)]
        dst[msk] = src[msk]

    new_mask = np.zeros((canvas.height, canvas.width), np.uint8)
    x0 = max(dst_min_x, 0)
    y0 = max(dst_min_y, 0)
    x1 = min(dst_min_x + tw, canvas.width)
    y1 = min(dst_min_y + th, canvas.height)
    if x1 > x0 and y1 > y0:
        sx0, sy0 = x0 - dst_min_x, y0 - dst_min_y
        new_mask[y0:y1, x0:x1] = tmask[sy0 : sy0 + (y1 - y0), sx0 : sx0 + (x1 - x0)]
    canvas.selection = new_mask
    return True


def _apply_all_layers(canvas: Canvas, transform: CanvasTransform):
    """The reference's whole-canvas flips/rotates transform ONLY
    layer.pixels (transform.rs flip_canvas_horizontal etc. —
    layer.par_iter_mut over pixels; live layer masks stay put, only
    rotate_canvas_arbitrary transforms them).  After a 90-degree rotate
    of a non-square canvas a stale mask keeps the old shape; the
    reference's sparse mask reads 0 out of bounds, which the dense model
    reproduces with a zero-pad/crop."""
    fn = _RGBA_FNS[transform]
    for layer in canvas.layers:
        layer.pixels = fn(layer.pixels)
    if transform in (CanvasTransform.ROT90_CW, CanvasTransform.ROT90_CCW):
        canvas.width, canvas.height = canvas.height, canvas.width
        for layer in canvas.layers:
            m = layer.mask
            if m is not None and m.shape[:2] != (canvas.height, canvas.width):
                fixed = np.zeros((canvas.height, canvas.width), m.dtype)
                ch = min(m.shape[0], canvas.height)
                cw = min(m.shape[1], canvas.width)
                fixed[:ch, :cw] = m[:ch, :cw]
                layer.mask = fixed


def _clear_preview(canvas: Canvas):
    """Drop the interactive stroke overlay before a canvas transform.
    NOTE a documented divergence: the reference clears previews only in
    the 90-degree/arbitrary-rotate and selected-region paths — its flips
    and 180-rotate KEEP the (now misaligned) overlay.  Keeping a stale
    overlay is display-only state there; in this headless model it would
    feed the next composite, so every transform clears it."""
    canvas.preview = None
    canvas.preview_replaces_layer = False
    canvas.preview_is_eraser = False


def flip_canvas_horizontal(canvas: Canvas):
    _clear_preview(canvas)
    if not _try_transform_selected_region(canvas, CanvasTransform.FLIP_H):
        _apply_all_layers(canvas, CanvasTransform.FLIP_H)


def flip_canvas_vertical(canvas: Canvas):
    _clear_preview(canvas)
    if not _try_transform_selected_region(canvas, CanvasTransform.FLIP_V):
        _apply_all_layers(canvas, CanvasTransform.FLIP_V)


def rotate_canvas_90cw(canvas: Canvas):
    _clear_preview(canvas)
    if not _try_transform_selected_region(canvas, CanvasTransform.ROT90_CW):
        _apply_all_layers(canvas, CanvasTransform.ROT90_CW)


def rotate_canvas_90ccw(canvas: Canvas):
    _clear_preview(canvas)
    if not _try_transform_selected_region(canvas, CanvasTransform.ROT90_CCW):
        _apply_all_layers(canvas, CanvasTransform.ROT90_CCW)


def rotate_canvas_180(canvas: Canvas):
    _clear_preview(canvas)
    if not _try_transform_selected_region(canvas, CanvasTransform.ROT180):
        _apply_all_layers(canvas, CanvasTransform.ROT180)


def rotate_canvas_arbitrary(canvas: Canvas, degrees: float,
                            interpolation: str = "bilinear", device="cuda"):
    """In-place rotation of every layer, canvas size unchanged; outside
    samples transparent (transform.rs:134-186).  The reference rotates layer
    masks with the same transform: each mask is repeated to four channels
    and rotated with the layers.  Every layer and mask of one shape goes
    through one tfm.rotate_arbitrary call on `device`: they share one
    coordinate map, and the bilinear gather is one batched K-warp launch."""
    if abs(degrees) < 0.001:
        return
    dev = resolve_device(device)
    _clear_preview(canvas)
    groups = {}  # source shape -> [(layer, slot)]
    for layer in canvas.layers:
        groups.setdefault(layer.pixels.shape[:2], []).append((layer, "pixels"))
        if layer.mask is not None:
            groups.setdefault(layer.mask.shape[:2], []).append((layer, "mask"))
    for items in groups.values():
        batch = torch.stack([
            upload(layer.pixels, dev) if slot == "pixels"
            else upload(layer.mask, dev)[..., None].expand(-1, -1, 4)
            for layer, slot in items])
        out = tfm.rotate_arbitrary(batch, degrees, interpolation, device=dev).cpu().numpy()
        for (layer, slot), rotated in zip(items, out):
            if slot == "pixels":
                layer.pixels = rotated
            else:
                layer.mask = np.ascontiguousarray(rotated[..., 0])


def resize_image(canvas: Canvas, new_w: int, new_h: int,
                 interpolation: str = "bilinear"):
    _clear_preview(canvas)
    for layer in canvas.layers:
        layer.pixels = tfm.resize(layer.pixels, new_w, new_h, interpolation)
        if layer.mask is not None:
            m = tfm.resize(np.repeat(layer.mask[..., None], 4, -1), new_w, new_h,
                           "nearest")
            layer.mask = m[..., 0]
    canvas.width, canvas.height = new_w, new_h
    canvas.selection = None


def resize_canvas(canvas: Canvas, new_w: int, new_h: int, anchor=(0, 0),
                  fill=(0, 0, 0, 0)):
    _clear_preview(canvas)
    for layer in canvas.layers:
        layer.pixels = tfm.resize_canvas(layer.pixels, new_w, new_h, anchor, fill)
        if layer.mask is not None:
            m4 = tfm.resize_canvas(np.repeat(layer.mask[..., None], 4, -1),
                                   new_w, new_h, anchor, (0, 0, 0, 0))
            layer.mask = m4[..., 0]
    canvas.width, canvas.height = new_w, new_h
    canvas.selection = None


def crop_to_selection(canvas: Canvas):
    """Crop the whole document to the selection's bounding box
    (adjustments.rs:737-786): every layer's pixels (and mask) are cut to
    the bbox of mask>0, the canvas dims shrink, and the selection clears.
    No-ops on no/empty selection, exactly like the reference."""
    if canvas.selection is None:
        return
    bounds = _selection_bounds(np.asarray(canvas.selection))
    if bounds is None:
        return
    min_x, min_y, max_x, max_y = bounds
    for layer in canvas.layers:
        if layer.deep_pixels is not None:
            # keep the high-bit-depth payload in sync with the u8 preview
            deep = layer.deep_pixels.data.reshape(
                layer.pixels.shape[0], layer.pixels.shape[1], 4)
            layer.deep_pixels.data = np.ascontiguousarray(
                deep[min_y:max_y + 1, min_x:max_x + 1]).reshape(-1)
        layer.pixels = np.ascontiguousarray(
            layer.pixels[min_y:max_y + 1, min_x:max_x + 1])
        if layer.mask is not None:
            layer.mask = np.ascontiguousarray(
                layer.mask[min_y:max_y + 1, min_x:max_x + 1])
    canvas.width = max_x - min_x + 1
    canvas.height = max_y - min_y + 1
    canvas.selection = None
    canvas.preview = None  # pre-crop-shaped overlay would misalign


def composite_viewport(canvas: Canvas, rect: Optional[Tuple[int, int, int, int]] = None,
                       device="cuda"):
    """Composite only a viewport window (x0, y0, x1, y1) — the dirty-rect
    incremental recompute analogue (canvas_state.rs:505); the flatten runs
    on `device`."""
    full = canvas.composite(device=device)
    if rect is None:
        return full
    x0, y0, x1, y1 = rect
    return full[max(y0, 0) : min(y1, canvas.height), max(x0, 0) : min(x1, canvas.width)]


LOD_MAX_EDGE = 1024


def composite_lod(canvas: Canvas, device="cuda") -> np.ndarray:
    """Downscaled composite for LOD display, longest edge <= 1024 via
    triangle filter (canvas_state.rs:487-500); the flatten runs on
    `device`, the resize on the host."""
    full = canvas.composite(device=device)
    h, w = full.shape[:2]
    longest = max(w, h)
    if longest <= LOD_MAX_EDGE:
        return full
    scale = LOD_MAX_EDGE / longest
    nw = max(int(round(w * scale)), 1)
    nh = max(int(round(h * scale)), 1)
    return tfm.resize(full, nw, nh, "bilinear")
