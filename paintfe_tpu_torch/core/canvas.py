"""Host-side document model: Canvas (layer stack), Layer, LayerFolder and
the layer-commit rules (paintfe_tpu.core.canvas counterpart).

Behavioral contract: `CanvasState` / `Layer` (src/canvas/canvas_state.rs:9-139,
src/canvas/layers.rs:366-421) minus the GUI caches.  Layer pixels stay numpy
u8 arrays on the host.  `Canvas.composite` flattens on a torch device: each
raster run is uploaded and folded by K-composite (core/composite.py), the
accumulator stays on the device across in-stream adjustment layers, the
active-tile mask is built there from the uploaded layers
(`active_tile_mask_device`), and the result is read back once.
`canvas_from_document` carries a document object of the JAX package
across.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from paintfe_tpu_torch.core.blend import BlendMode, blend_u8
from paintfe_tpu_torch.utils.quant import ieee_div

TILE = 64  # reference chunk size (canvas/defs.rs:7)
MAX_PIXELS = 256_000_000  # reference clamp (tiled_image.rs:14-26)


def clamp_dimensions(width: int, height: int) -> Tuple[int, int]:
    """TiledImage::new's overflow guard: >256 Mpix (or a zero dimension)
    clamps to 1x1 with a warning rather than erroring."""
    if width * height > MAX_PIXELS or width <= 0 or height <= 0:
        print(f"Canvas: dimensions {width}x{height} exceed 256M pixels, "
              "clamped to 1x1", file=sys.stderr)
        return 1, 1
    return width, height


def canonicalize_tiles(img: np.ndarray, tile: int = TILE) -> np.ndarray:
    """Zero out RGB of fully-transparent 64x64 tiles: the reference's
    sparse tile store drops fully-transparent chunks, so their color data
    reads back as zeros."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    out = img.copy()
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            blk = out[ty:ty + tile, tx:tx + tile]
            if not blk[..., 3].any():
                blk[...] = 0
    return out


@dataclasses.dataclass
class Layer:
    """One layer: straight-alpha RGBA u8 pixels + blend state.

    `content` discriminates Raster / Adjustment / Text (layers.rs:366-375);
    adjustment layers transform the accumulated composite in-stream.
    Deep-pixel payloads (u16/f16/f32) ride alongside the u8 preview."""

    name: str
    pixels: np.ndarray  # u8 [H, W, 4]
    visible: bool = True
    opacity: float = 1.0
    blend_mode: BlendMode = BlendMode.NORMAL
    mask: Optional[np.ndarray] = None  # u8 [H, W] conceal (0 = show)
    mask_enabled: bool = True
    folder_id: Optional[int] = None
    content: str = "raster"  # raster | adjustment | text
    adjustment: Optional[Any] = None  # deep.AdjustmentLayerData
    text_data: Optional[Any] = None  # ops.text_layer.TextLayerData
    pixel_format: Any = None  # deep.PixelFormat (None -> RGBA_U8)
    deep_pixels: Optional[Any] = None  # deep.DeepRgbaBuffer
    hdr_metadata: Optional[Any] = None  # deep.HdrMetadata
    source_metadata: Optional[Any] = None  # deep.ImageMetadata

    @classmethod
    def new(cls, name: str, w: int, h: int, fill=(0, 0, 0, 0)) -> "Layer":
        px = np.empty((h, w, 4), np.uint8)
        px[...] = np.asarray(fill, np.uint8)
        return cls(name=name, pixels=px)

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    def clone(self) -> "Layer":
        """A copy with value semantics, like the Rust Layer Clone: the
        pixels, the mask and every optional payload (deep buffer,
        adjustment, text, metadata) are copied, since edit paths mutate
        payloads in place and a snapshot sharing one would change with the
        live layer."""
        return dataclasses.replace(
            self,
            pixels=self.pixels.copy(),
            mask=None if self.mask is None else self.mask.copy(),
            deep_pixels=copy.deepcopy(self.deep_pixels),
            adjustment=copy.deepcopy(self.adjustment),
            text_data=copy.deepcopy(self.text_data),
            hdr_metadata=copy.deepcopy(self.hdr_metadata),
            source_metadata=copy.deepcopy(self.source_metadata),
        )


@dataclasses.dataclass
class LayerFolder:
    id: int
    name: str
    visible: bool = True
    expanded: bool = True


def upload(host: np.ndarray, device) -> torch.Tensor:
    """A host u8 array as a tensor on `device` (shares memory on the CPU)."""
    return torch.from_numpy(np.ascontiguousarray(host, np.uint8)).to(device)


@dataclasses.dataclass
class Canvas:
    """The document: an ordered layer stack (bottom first) + selection mask."""

    width: int
    height: int
    layers: List[Layer] = dataclasses.field(default_factory=list)
    folders: List[LayerFolder] = dataclasses.field(default_factory=list)
    active_layer_index: int = 0
    # Selection: None = everything selected; else u8 [H, W], 0 or 255.
    selection: Optional[np.ndarray] = None
    # Interactive preview overlay for the active layer (canvas_state.rs:24-127):
    # pre-blended into the active layer before compositing so it inherits
    # the layer's blend mode and opacity.
    # u8 [H, W, 4]: a host array, or a tensor a stroke keeps on its device
    preview: Optional[Any] = None
    preview_blend_mode: BlendMode = BlendMode.NORMAL
    preview_is_eraser: bool = False
    preview_replaces_layer: bool = False

    @classmethod
    def new(cls, width: int, height: int, background=(0, 0, 0, 0)) -> "Canvas":
        width, height = clamp_dimensions(width, height)
        c = cls(width=width, height=height)
        c.layers.append(Layer.new("Background", width, height, background))
        return c

    @classmethod
    def from_image(cls, img: np.ndarray) -> "Canvas":
        img = np.asarray(img, np.uint8)
        h, w = img.shape[:2]
        # imported images pass through the same 256-Mpix guard as new canvases
        cw, ch = clamp_dimensions(w, h)
        if (cw, ch) != (w, h):
            img = img[:ch, :cw]
        c = cls(width=img.shape[1], height=img.shape[0])
        c.layers.append(Layer(name="Background", pixels=img.copy()))
        return c

    # -- layer queries ------------------------------------------------------

    def folder_visible(self, folder_id: Optional[int]) -> bool:
        if folder_id is None:
            return True
        for f in self.folders:
            if f.id == folder_id:
                return f.visible
        return True

    def layer_effectively_visible(self, idx: int) -> bool:
        layer = self.layers[idx]
        return layer.visible and self.folder_visible(layer.folder_id)

    def visible_layers(self):
        """[(index, layer)] of the effectively visible layers, bottom first."""
        return [(i, l) for i, l in enumerate(self.layers)
                if self.layer_effectively_visible(i)]

    @property
    def active_layer(self) -> Layer:
        return self.layers[self.active_layer_index]

    # -- compositing --------------------------------------------------------

    def composite(self, device="cuda") -> np.ndarray:
        """Flatten the visible stack to a single RGBA u8 [H, W, 4] image on
        `device` (the card unless the caller passes "cpu"; CUDA with no
        card raises RuntimeError): raster runs fold on the device, adjustment
        layers transform the accumulated composite in-stream
        (canvas_state.rs:579-584), and the result is read back once."""
        from paintfe_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        return flatten(self, lambda layer: upload(layer.pixels, dev),
                       lambda layer: upload(layer.mask, dev), dev).cpu().numpy()

    def active_tile_mask(self, vis, rect=None) -> Optional[np.ndarray]:
        """Per-pixel bool mask of 64x64 tiles where some visible raster
        layer (or the preview overlay) holds data: "chunk exists" is "any
        alpha nonzero in the tile".  Returns None when every tile is
        active.  `rect` = (y0, x0, bh, bw) restricts it to the tiles
        intersecting that window and returns the mask slice for exactly
        that window (tiles stay aligned to the global 64 px grid).  This
        is the definition, on the host; the flatten builds the same mask
        on its device (active_tile_mask_device)."""
        y0, x0, bh, bw = (0, 0, self.height, self.width) if rect is None else rect
        ty0, tx0, rh, rw = tile_window(self.height, self.width, rect)
        any_alpha = np.zeros((rh, rw), bool)
        for _, layer in vis:
            if layer.content == "adjustment":
                continue
            any_alpha |= layer.pixels[ty0:ty0 + rh, tx0:tx0 + rw, 3] > 0
        if self.preview is not None:
            any_alpha |= self.preview[ty0:ty0 + rh, tx0:tx0 + rw, 3] > 0
        th = -(-rh // TILE)
        tw = -(-rw // TILE)
        padded = np.zeros((th * TILE, tw * TILE), bool)
        padded[:rh, :rw] = any_alpha
        tiles = padded.reshape(th, TILE, tw, TILE).any(axis=(1, 3))
        if tiles.all():
            return None
        expanded = np.repeat(np.repeat(tiles, TILE, axis=0), TILE, axis=1)
        return expanded[y0 - ty0:y0 - ty0 + bh, x0 - tx0:x0 - tx0 + bw]

    def _apply_preview(self, pixels: torch.Tensor, preview: torch.Tensor) -> torch.Tensor:
        """Pre-blend the preview into the active layer's pixels on their
        device (canvas_state.rs:619-658): replace / eraser-mask /
        coverage-weighted Overwrite-Xor lerp / plain blend.  `pixels` and
        `preview` are u8 [h, w, 4] tensors on one device (the dirty-rect
        path passes matching windows of both); neither is written."""
        if self.preview_replaces_layer:
            return preview.clone()
        has = preview[..., 3] > 0
        if self.preview_is_eraser:
            strength = ieee_div(preview[..., 3].float(), 255.0)
            cur = ieee_div(pixels[..., 3].float(), 255.0)
            new_a = (torch.clamp(cur * (1.0 - strength), min=0.0) * 255.0).to(torch.uint8)
            alpha = torch.where(has, new_a, pixels[..., 3])
            return torch.cat([pixels[..., :3], alpha[..., None]], dim=-1)
        blended = blend_u8(pixels, preview, int(self.preview_blend_mode), 1.0)
        if self.preview_blend_mode in (BlendMode.OVERWRITE, BlendMode.XOR):
            cov = ieee_div(preview[..., 3:4].float(), 255.0)
            mixed = (pixels.float() * (1.0 - cov) + blended.float() * cov + 0.5).to(torch.uint8)
            return torch.where(has[..., None], mixed, pixels)
        return torch.where(has[..., None], blended, pixels)

    # -- selection ----------------------------------------------------------

    def selection_mask_f32(self) -> Optional[np.ndarray]:
        """Selection as f32 [H, W] in {0, 1}, or None when all selected."""
        if self.selection is None:
            return None
        return (self.selection > 0).astype(np.float32)

    def has_selection(self) -> bool:
        return self.selection is not None


def tile_window(height: int, width: int, rect=None) -> Tuple[int, int, int, int]:
    """(ty0, tx0, rh, rw): `rect` = (y0, x0, bh, bw) grown to the global
    64 px tile grid and cut to the canvas; the whole canvas for no rect."""
    y0, x0, bh, bw = (0, 0, height, width) if rect is None else rect
    ty0 = (y0 // TILE) * TILE
    tx0 = (x0 // TILE) * TILE
    rh = min(-(-(y0 + bh) // TILE) * TILE, height) - ty0
    rw = min(-(-(x0 + bw) // TILE) * TILE, width) - tx0
    return ty0, tx0, rh, rw


def active_tile_mask_device(alphas, height: int, width: int, rect=None) -> torch.Tensor:
    """Canvas.active_tile_mask on the device that holds the pixels.

    `alphas` are the u8 alpha planes (views will do) of the visible raster
    layers, raw, and of the preview overlay, each cut to
    tile_window(height, width, rect).  Returns the bool [bh, bw] mask of
    `rect` (the canvas for no rect): True where the pixel's 64 px tile has
    a nonzero alpha in some plane.  Where the host version returns None
    this one is all True; it never reads a value back to the host."""
    y0, x0, bh, bw = (0, 0, height, width) if rect is None else rect
    ty0, tx0, rh, rw = tile_window(height, width, rect)
    th, tw = -(-rh // TILE), -(-rw // TILE)
    tiles = None
    for alpha in alphas:
        padded = torch.zeros((th * TILE, tw * TILE), dtype=torch.bool, device=alpha.device)
        torch.ne(alpha, 0, out=padded[:rh, :rw])
        live = padded.view(th, TILE, tw, TILE).any(dim=3).any(dim=1)
        tiles = live if tiles is None else tiles | live
    if tiles is None:
        raise ValueError("active_tile_mask_device: no alpha planes")
    keep = tiles.repeat_interleave(TILE, dim=0).repeat_interleave(TILE, dim=1)
    return keep[y0 - ty0:y0 - ty0 + bh, x0 - tx0:x0 - tx0 + bw]


def flatten(canvas: Canvas, pixels: Callable, conceal: Callable, device,
            rect=None) -> torch.Tensor:
    """The flatten shared by Canvas.composite and core/device.py: fold the
    visible stack on `device` and return the u8 [bh, bw, 4] result there.

    `pixels(layer)` gives a raster layer's raw u8 pixels on the device at
    canvas size, `conceal(layer)` its live mask; the flatten cuts both to
    `rect` = (y0, x0, bh, bw) when one is given, uploads the preview's
    window and pre-blends it into the active layer.  Raster runs fold with
    K-composite (core/composite.py); adjustment layers apply in-stream to
    the accumulator; when any did, tiles with no data in any visible layer
    are cleared (the reference only composites chunks present in some
    layer's store, canvas_state.rs:528-551; without this, e.g. Invert would
    turn empty tiles (255,255,255,0)).  That mask comes from the raw layers'
    and the preview's alpha as they lie on the device."""
    from paintfe_tpu_torch.core.composite import composite_stack_static

    y0, x0, bh, bw = (0, 0, canvas.height, canvas.width) if rect is None else rect
    vis = canvas.visible_layers()
    has_adjustment = any(l.content == "adjustment" and l.adjustment is not None
                         for _, l in vis)
    # the mask needs whole tiles: with an adjustment layer the preview is
    # uploaded at the rect grown to the tile grid, else at the rect
    ty0, tx0, rh, rw = (tile_window(canvas.height, canvas.width, rect) if has_adjustment
                        else (y0, x0, bh, bw))

    def window(t):
        return t if rect is None else t[y0:y0 + bh, x0:x0 + bw].contiguous()

    alphas = []  # of the raw raster layers and the preview, at the tile window
    preview = None
    if canvas.preview is not None:
        grown = canvas.preview[ty0:ty0 + rh, tx0:tx0 + rw]
        # a stroke's preview may stay resident on the device as a tensor
        grown = (grown.to(device) if isinstance(grown, torch.Tensor)
                 else upload(grown, device))
        alphas.append(grown[..., 3])
        preview = grown[y0 - ty0:y0 - ty0 + bh, x0 - tx0:x0 - tx0 + bw].contiguous()
    acc = None  # transparent until the first run or adjustment
    run = []  # (pixels, mode, opacity, conceal or None)

    def flush(acc):
        if not run:
            return acc
        px, modes, opac, masks = zip(*run)
        run.clear()
        live = any(m is not None for m in masks)
        return composite_stack_static(list(px), modes, np.asarray(opac, np.float32),
                                      list(masks) if live else None, init=acc)

    for idx, layer in vis:
        if layer.content == "adjustment" and layer.adjustment is not None:
            acc = flush(acc)
            if acc is None:
                acc = torch.zeros((bh, bw, 4), dtype=torch.uint8, device=device)
            acc = layer.adjustment.apply_with_opacity(acc, layer.opacity)
            continue
        raw = pixels(layer)
        if layer.content != "adjustment":
            alphas.append(raw[ty0:ty0 + rh, tx0:tx0 + rw, 3])
        px = window(raw)
        if idx == canvas.active_layer_index and preview is not None:
            px = canvas._apply_preview(px, preview)
        mask = (window(conceal(layer)) if layer.mask is not None and layer.mask_enabled
                else None)
        run.append((px, int(layer.blend_mode), layer.opacity, mask))
    out = flush(acc)
    if out is None:
        return torch.zeros((bh, bw, 4), dtype=torch.uint8, device=device)
    if has_adjustment and alphas:
        keep = active_tile_mask_device(alphas, canvas.height, canvas.width, rect)
        out = torch.where(keep[..., None], out, 0)
    elif has_adjustment:
        out = torch.zeros_like(out)  # no raster layer: no tile holds data
    return out


# ---------------------------------------------------------------------------
# State carry-across from the JAX package's document model
# ---------------------------------------------------------------------------


def _array(x, dtype=None):
    return None if x is None else np.array(x, dtype=dtype)


def _enum_value(v):
    return getattr(v, "value", v)


def canvas_from_document(doc) -> Canvas:
    """The port's Canvas from any object with the JAX package's Canvas
    fields (width, height, layers, folders, active_layer_index, selection,
    preview state), reading numpy arrays and plain values only: the
    counterpart of parallel/pipeline.from_jax_ops.  A text layer's text
    data crosses as ops.text_layer's classes, through the JSON the .pfe
    container carries (which reads dataclass fields and enum values
    only)."""
    from paintfe_tpu_torch.core import deep
    from paintfe_tpu_torch.ops.text_layer import text_data_from_json, text_data_to_json

    def adjustment(a):
        if a is None:
            return None
        return deep.AdjustmentLayerData(
            kind=deep.AdjustmentKind(int(a.kind)), ev=float(a.ev),
            brightness=float(a.brightness), contrast=float(a.contrast),
            red=tuple(float(v) for v in a.red), green=tuple(float(v) for v in a.green),
            blue=tuple(float(v) for v in a.blue), alpha=tuple(float(v) for v in a.alpha))

    def deep_buffer(b):
        if b is None:
            return None
        return deep.DeepRgbaBuffer(deep.PixelFormat(_enum_value(b.format)),
                                   np.array(b.data))

    def hdr(h):
        if h is None:
            return None
        return deep.HdrMetadata(bool(h.enabled), h.max_luminance_nits,
                                h.reference_white_nits, h.transfer_function)

    def meta(m):
        if m is None:
            return None
        return deep.ImageMetadata(m.source_format, m.source_name, m.color_profile_name,
                                  [tuple(kv) for kv in m.png_text_chunks])

    layers = []
    for l in doc.layers:
        text = getattr(l, "text_data", None)
        fmt = getattr(l, "pixel_format", None)
        layers.append(Layer(
            name=str(l.name), pixels=_array(l.pixels, np.uint8), visible=bool(l.visible),
            opacity=float(l.opacity), blend_mode=BlendMode(int(l.blend_mode)),
            mask=_array(l.mask, np.uint8), mask_enabled=bool(l.mask_enabled),
            folder_id=None if l.folder_id is None else int(l.folder_id),
            content=str(l.content), adjustment=adjustment(l.adjustment),
            text_data=None if text is None else text_data_from_json(text_data_to_json(text)),
            pixel_format=None if fmt is None else deep.PixelFormat(_enum_value(fmt)),
            deep_pixels=deep_buffer(l.deep_pixels), hdr_metadata=hdr(l.hdr_metadata),
            source_metadata=meta(l.source_metadata)))
    return Canvas(
        width=int(doc.width), height=int(doc.height), layers=layers,
        folders=[LayerFolder(int(f.id), str(f.name), bool(f.visible), bool(f.expanded))
                 for f in doc.folders],
        active_layer_index=int(doc.active_layer_index),
        selection=_array(doc.selection, np.uint8), preview=_array(doc.preview, np.uint8),
        preview_blend_mode=BlendMode(int(doc.preview_blend_mode)),
        preview_is_eraser=bool(doc.preview_is_eraser),
        preview_replaces_layer=bool(doc.preview_replaces_layer))
