"""Document-model operations: layer CRUD, merge, layer masks, channels
(paintfe_tpu.ops.canvas_ops counterpart).

Behavioral contract: src/ops/canvas_ops.rs (channel extract/replace
:32-95, merge-down-as-mask :97-163, layer masks :165-296, add/delete/
duplicate :298-430) and src/components/layers/operations.rs:790-860
(merge_down via blend_pixel_static).

Host numpy as in the JAX package, except the two functions that
composite: merge_down folds the top layer over the one below on
K-composite (the layer below as the initial accumulator, no conceal
mask: the JAX package's blend_u8 of the pair), and flatten runs the
flatten of Canvas.composite.  Both run on `device`, the card unless the
caller passes "cpu".  Every op assigns a new pixel or mask array and
never writes into the one a layer holds.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from paintfe_tpu_torch.core.canvas import Canvas, Layer, upload
from paintfe_tpu_torch.core.composite import composite_stack_static
from paintfe_tpu_torch.utils.device import resolve_device

f32 = np.float32


class ImageChannel(enum.Enum):
    RED = 0
    GREEN = 1
    BLUE = 2
    ALPHA = 3
    LUMINANCE = 4


def _sample_channel(pixels: np.ndarray, channel: ImageChannel) -> np.ndarray:
    if channel == ImageChannel.LUMINANCE:
        v = (0.299 * pixels[..., 0].astype(f32)
             + 0.587 * pixels[..., 1].astype(f32)
             + 0.114 * pixels[..., 2].astype(f32))
        return np.minimum(np.floor(v + f32(0.5)), 255.0).astype(np.uint8)
    return pixels[..., channel.value]


def extract_channel_to_layer(canvas: Canvas, layer_idx: int, channel: ImageChannel):
    """Insert a grayscale layer of the chosen channel above `layer_idx`."""
    v = _sample_channel(canvas.layers[layer_idx].pixels, ImageChannel(channel))
    px = np.stack([v, v, v, np.full_like(v, 255)], axis=-1)
    layer = Layer(name=f"{ImageChannel(channel).name.title()} Channel", pixels=px)
    insert_idx = layer_idx + 1
    canvas.layers.insert(insert_idx, layer)
    canvas.active_layer_index = insert_idx


def replace_channel_from_layer(canvas: Canvas, target_idx: int, source_idx: int,
                               target_channel: ImageChannel,
                               source_channel: ImageChannel):
    v = _sample_channel(canvas.layers[source_idx].pixels, ImageChannel(source_channel))
    tc = ImageChannel(target_channel)
    c = 3 if tc in (ImageChannel.ALPHA, ImageChannel.LUMINANCE) else tc.value
    # replace, never mutate: the device-layer cache keys on host-array
    # identity (core/device.py)
    px = canvas.layers[target_idx].pixels.copy()
    px[..., c] = v
    canvas.layers[target_idx].pixels = px


def merge_down(canvas: Canvas, layer_idx: int, device="cuda"):
    """Blend layer `layer_idx` onto the one below with its mode/opacity, then
    remove it (operations.rs:790-860).  The blend is one K-composite fold
    on `device`: the top layer over the one below as the initial
    accumulator (the top layer's mask does not apply, as in the
    reference)."""
    if layer_idx == 0 or layer_idx >= len(canvas.layers):
        return
    dev = resolve_device(device)
    # auto-rasterize text layers before merging (operations.rs:803-809:
    # pixels must be up to date, and the survivor becomes a raster layer
    # so a later rasterize/PFE round-trip can't regenerate the text over
    # the merged result)
    for idx in (layer_idx, layer_idx - 1):
        layer = canvas.layers[idx]
        if getattr(layer, "content", "raster") == "text":
            from paintfe_tpu_torch.ops.text_layer import ensure_text_layers_rasterized

            ensure_text_layers_rasterized(canvas, dev)
            layer.content = "raster"
            layer.text_data = None
    top = canvas.layers[layer_idx]
    if top.visible:
        below = canvas.layers[layer_idx - 1]
        below.pixels = composite_stack_static(
            [upload(top.pixels, dev)], [int(top.blend_mode)],
            np.asarray([top.opacity], f32), init=upload(below.pixels, dev),
        ).cpu().numpy()
    canvas.layers.pop(layer_idx)
    if canvas.active_layer_index >= layer_idx and canvas.active_layer_index > 0:
        canvas.active_layer_index -= 1


def merge_down_as_mask(canvas: Canvas, layer_idx: int):
    """Use the top layer's luminance as an alpha mask for the layer below:
    effective = lerp(255, luminance, alpha/255); only painted dark areas
    erase (canvas_ops.rs:97-163)."""
    if layer_idx == 0 or layer_idx >= len(canvas.layers):
        return
    top = canvas.layers[layer_idx].pixels
    below = canvas.layers[layer_idx - 1]
    lum = (0.299 * top[..., 0].astype(f32) + 0.587 * top[..., 1].astype(f32)
           + 0.114 * top[..., 2].astype(f32))
    a = top[..., 3].astype(f32) / f32(255.0)
    # lerp(255, luma, alpha) truncated to u8, then integer alpha scale
    mask_luma = (f32(255.0) * (f32(1.0) - a) + lum * a + f32(0.5)).astype(np.uint8)
    new_a = below.pixels[..., 3].astype(np.uint32) * mask_luma.astype(np.uint32) // 255
    # replace (never mutate in place): the device-layer cache revalidates
    # by host-array identity (core/device.py) — an in-place write would
    # keep serving the stale upload
    px = below.pixels.copy()
    px[..., 3] = new_a.astype(np.uint8)
    below.pixels = px
    canvas.layers.pop(layer_idx)
    if canvas.active_layer_index >= layer_idx and canvas.active_layer_index > 0:
        canvas.active_layer_index -= 1


# ---------------------------------------------------------------------------
# Layer masks (conceal semantics: 0 = show, 255 = hide)
# ---------------------------------------------------------------------------


def add_layer_mask_reveal_all(canvas: Canvas, layer_idx: int):
    layer = canvas.layers[layer_idx]
    if layer.mask is not None:
        layer.mask_enabled = True
        return
    layer.mask = np.zeros((canvas.height, canvas.width), np.uint8)
    layer.mask_enabled = True


def add_layer_mask_from_selection(canvas: Canvas, layer_idx: int):
    """Selection=255 reveals fully -> conceal = 255 - reveal."""
    layer = canvas.layers[layer_idx]
    if layer.mask is not None:
        layer.mask_enabled = True
        return
    if canvas.selection is not None:
        layer.mask = (255 - canvas.selection).astype(np.uint8)
    else:
        layer.mask = np.zeros((canvas.height, canvas.width), np.uint8)
    layer.mask_enabled = True


def toggle_layer_mask(canvas: Canvas, layer_idx: int):
    layer = canvas.layers[layer_idx]
    if layer.mask is not None:
        layer.mask_enabled = not layer.mask_enabled


def invert_layer_mask(canvas: Canvas, layer_idx: int):
    layer = canvas.layers[layer_idx]
    if layer.mask is None:
        return
    layer.mask = (255 - layer.mask).astype(np.uint8)
    layer.mask_enabled = True


def apply_layer_mask(canvas: Canvas, layer_idx: int):
    """Bake the conceal mask into alpha with u32 integer math, then drop it."""
    layer = canvas.layers[layer_idx]
    if layer.mask is None:
        return
    conceal = layer.mask.astype(np.uint32)
    a = layer.pixels[..., 3].astype(np.uint32)
    # replace, never mutate: the device-layer cache keys on host-array
    # identity (core/device.py)
    px = layer.pixels.copy()
    px[..., 3] = np.where(
        conceal > 0, (a * (255 - conceal)) // 255, a
    ).astype(np.uint8)
    layer.pixels = px
    layer.mask = None
    layer.mask_enabled = True


def delete_layer_mask(canvas: Canvas, layer_idx: int):
    layer = canvas.layers[layer_idx]
    layer.mask = None
    layer.mask_enabled = True


# ---------------------------------------------------------------------------
# Layer CRUD
# ---------------------------------------------------------------------------


def add_layer(canvas: Canvas, name: Optional[str] = None) -> int:
    """Insert a transparent layer above the active one; returns its index."""
    idx = min(canvas.active_layer_index + 1, len(canvas.layers))
    layer = Layer.new(name or f"Layer {len(canvas.layers) + 1}",
                      canvas.width, canvas.height)
    canvas.layers.insert(idx, layer)
    canvas.active_layer_index = idx
    return idx


def delete_layer(canvas: Canvas, layer_idx: Optional[int] = None):
    idx = canvas.active_layer_index if layer_idx is None else layer_idx
    if idx >= len(canvas.layers):
        return
    canvas.layers.pop(idx)
    if canvas.active_layer_index >= len(canvas.layers):
        canvas.active_layer_index = max(len(canvas.layers) - 1, 0)


def duplicate_layer(canvas: Canvas, layer_idx: Optional[int] = None) -> int:
    idx = canvas.active_layer_index if layer_idx is None else layer_idx
    src = canvas.layers[idx]
    copy = src.clone()
    copy.name = f"{src.name} Copy"  # capital C (canvas_ops.rs:395)
    canvas.layers.insert(idx + 1, copy)
    canvas.active_layer_index = idx + 1
    return idx + 1


def move_layer(canvas: Canvas, from_idx: int, to_idx: int):
    layer = canvas.layers.pop(from_idx)
    canvas.layers.insert(to_idx, layer)
    canvas.active_layer_index = to_idx


def flatten(canvas: Canvas, device="cuda"):
    """Composite all visible layers into a single Background layer
    (transform.rs:467-483); the flatten runs on `device`."""
    composite = canvas.composite(device=device)
    canvas.layers = [Layer(name="Background", pixels=composite)]
    canvas.active_layer_index = 0


# ---------------------------------------------------------------------------
# Layer alignment (transform.rs:648-745)
# ---------------------------------------------------------------------------


def nontransparent_bounds(img: np.ndarray):
    """Bounding box of pixels with alpha > 0, or None (transform.rs:696-727)."""
    alpha = np.asarray(img)[..., 3]
    ys, xs = np.nonzero(alpha)
    if ys.size == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def translate_image_clipped(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Shift by (dx, dy), dropping pixels that leave the canvas
    (transform.rs:729-745)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    out = np.zeros_like(img)
    sx0, sx1 = max(0, -dx), min(w, w - dx)
    sy0, sy1 = max(0, -dy), min(h, h - dy)
    if sx0 < sx1 and sy0 < sy1:
        out[sy0 + dy:sy1 + dy, sx0 + dx:sx1 + dx] = img[sy0:sy1, sx0:sx1]
    return out


def align_layer_to_anchor(canvas, layer_idx: int, anchor,
                          target_bounds=None) -> bool:
    """Align a layer's non-transparent content to a 3x3 anchor grid
    (transform.rs:648-694).  anchor = (ax, ay) with 0=start 1=center
    2=end; target_bounds = (x0, y0, x1, y1) inclusive, default canvas."""
    if layer_idx >= len(canvas.layers):
        return False
    flat = np.asarray(canvas.layers[layer_idx].pixels)
    bounds = nontransparent_bounds(flat)
    if bounds is None:
        return False
    min_x, min_y, max_x, max_y = bounds
    bw = max_x - min_x + 1
    bh = max_y - min_y + 1
    tx0, ty0, tx1, ty1 = (
        target_bounds if target_bounds is not None
        else (0, 0, canvas.width - 1, canvas.height - 1)
    )
    tw = tx1 - tx0 + 1
    th = ty1 - ty0 + 1
    ax, ay = anchor

    def _div2_trunc(v: int) -> int:
        # Rust i32 division truncates toward zero (transform.rs:677-687);
        # Python // floors, off by one when the content exceeds the target
        # bounds by an odd amount (v negative)
        return -((-v) // 2) if v < 0 else v // 2

    target_min_x = tx0 if ax == 0 else (
        tx0 + _div2_trunc(tw - bw) if ax == 1 else tx1 + 1 - bw)
    target_min_y = ty0 if ay == 0 else (
        ty0 + _div2_trunc(th - bh) if ay == 1 else ty1 + 1 - bh)
    canvas.layers[layer_idx].pixels = translate_image_clipped(
        flat, target_min_x - min_x, target_min_y - min_y
    )
    return True
