"""PFE project container, bincode-compatible (paintfe_tpu.io.pfe
counterpart).

Behavioral contract: src/io.rs:85-503 — magic "PFE0".."PFE3", bincode v1
fixed-int little-endian encoding: String/Vec = u64 length + payload,
usize = u64, Option = u8 tag, bool = u8, f32 = 4 LE bytes.  Sparse chunked
layers: only non-transparent 64x64 chunks serialized (16384 bytes each).

Implements V1 write for plain raster stacks, V2 when text layers are
present, V3 when experimental features are (folders, adjustment layers,
deep pixels, HDR, non-u8 formats, source metadata), and V0/V1/V2/V3 read
— the same auto-selection ladder as build_pfe (io.rs:256-283), byte for
byte.  A text layer's payload is ops/text_layer.py's JSON, written and read
as the JAX package does (a payload it cannot decode leaves the layer its
rasterized pixels).
"""

from __future__ import annotations

import io
import struct

import numpy as np

from paintfe_tpu_torch.core.blend import BlendMode
from paintfe_tpu_torch.core.canvas import Canvas, Layer, LayerFolder
from paintfe_tpu_torch.core.deep import (
    AdjustmentKind,
    AdjustmentLayerData,
    DeepRgbaBuffer,
    HdrMetadata,
    ImageMetadata,
    PixelFormat,
)

CHUNK = 64


class PfeError(Exception):
    pass


def _enum_tag(table, tag: int, what: str):
    """Bounds-checked bincode enum read: a corrupt tag must surface as
    PfeError (the CLI's per-file keep-going contract), not IndexError."""
    if not 0 <= tag < len(table):
        raise PfeError(f"corrupt PFE: invalid {what} tag {tag}")
    return table[tag]


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise PfeError("unexpected end of file")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def string(self) -> str:
        n = self.u64()
        return self.take(n).decode("utf-8")

    def bytes_vec(self) -> bytes:
        n = self.u64()
        return self.take(n)

    def option(self, read_fn):
        return read_fn() if self.u8() == 1 else None


class _Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def u8(self, v):
        self.buf.write(struct.pack("<B", v))

    def u32(self, v):
        self.buf.write(struct.pack("<I", v))

    def u64(self, v):
        self.buf.write(struct.pack("<Q", v))

    def f32(self, v):
        self.buf.write(struct.pack("<f", v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u64(len(b))
        self.buf.write(b)

    def bytes_vec(self, b: bytes):
        self.u64(len(b))
        self.buf.write(b)

    def getvalue(self):
        return self.buf.getvalue()


def _chunks_of(pixels: np.ndarray):
    """Yield (cx, cy, 64x64 RGBA bytes) for non-transparent chunks."""
    h, w = pixels.shape[:2]
    for cy in range(0, (h + CHUNK - 1) // CHUNK):
        for cx in range(0, (w + CHUNK - 1) // CHUNK):
            y0, x0 = cy * CHUNK, cx * CHUNK
            blk = pixels[y0 : y0 + CHUNK, x0 : x0 + CHUNK]
            if not blk[..., 3].any():
                continue
            full = np.zeros((CHUNK, CHUNK, 4), np.uint8)
            full[: blk.shape[0], : blk.shape[1]] = blk
            yield cx, cy, full.tobytes()


def _paste_chunks(w: int, h: int, chunks) -> np.ndarray:
    out = np.zeros((h, w, 4), np.uint8)
    for cx, cy, data in chunks:
        blk = np.frombuffer(data, np.uint8).reshape(CHUNK, CHUNK, 4)
        y0, x0 = cy * CHUNK, cx * CHUNK
        ch = min(CHUNK, h - y0)
        cw = min(CHUNK, w - x0)
        if ch > 0 and cw > 0:
            out[y0 : y0 + ch, x0 : x0 + cw] = blk[:ch, :cw]
    return out


_PIXEL_FORMATS = [PixelFormat.RGBA_U8, PixelFormat.RGBA_U16,
                  PixelFormat.RGBA_F16, PixelFormat.RGBA_F32]
_ADJ_KINDS = [AdjustmentKind.EXPOSURE, AdjustmentKind.BRIGHTNESS_CONTRAST,
              AdjustmentKind.INVERT, AdjustmentKind.CHANNEL_MIXER]


def _meta_nonempty(meta) -> bool:
    return meta is not None and (
        meta.source_format is not None or bool(meta.png_text_chunks)
    )


def _needs_v3(canvas: Canvas) -> bool:
    """V3 feature detection mirroring build_pfe's has_experimental_layers
    (io.rs:257-276): adjustment layers, non-u8 formats, HDR, deep pixels,
    source metadata (source_format / png_text_chunks), or folders."""
    if canvas.folders or any(l.folder_id is not None for l in canvas.layers):
        return True
    return any(
        l.content == "adjustment"
        or l.deep_pixels is not None
        or (l.pixel_format not in (None, PixelFormat.RGBA_U8))
        or (l.hdr_metadata is not None and l.hdr_metadata.enabled)
        or _meta_nonempty(l.source_metadata)
        for l in canvas.layers
    )


def _text_payload(layer) -> bytes:
    from paintfe_tpu_torch.ops.text_layer import text_data_to_json

    return text_data_to_json(layer.text_data)


def save_pfe(canvas: Canvas, path: str):
    """Write a V1 container, V2 when text layers are present, or V3 when
    experimental features are (build_pfe auto-selection, io.rs:256-283)."""
    if _needs_v3(canvas):
        return _save_v3(canvas, path)
    has_text = any(l.content == "text" for l in canvas.layers)
    v2 = has_text
    wtr = _Writer()
    wtr.string("PFE2" if v2 else "PFE1")
    wtr.u32(canvas.width)
    wtr.u32(canvas.height)
    wtr.u64(canvas.active_layer_index)
    wtr.u64(len(canvas.layers))
    for layer in canvas.layers:
        wtr.string(layer.name)
        wtr.u8(1 if layer.visible else 0)
        wtr.f32(layer.opacity)
        wtr.u8(int(layer.blend_mode))
        if v2:
            wtr.u8(1 if layer.content == "text" else 0)  # layer_type
        chunks = list(_chunks_of(np.asarray(layer.pixels, np.uint8)))
        wtr.u64(len(chunks))
        for cx, cy, data in chunks:
            wtr.u32(cx)
            wtr.u32(cy)
            wtr.bytes_vec(data)
        if v2:
            if layer.content == "text" and layer.text_data is not None:
                wtr.u8(1)
                wtr.bytes_vec(_text_payload(layer))
            else:
                wtr.u8(0)
    with open(path, "wb") as f:
        f.write(wtr.getvalue())


def load_pfe(path: str) -> Canvas:
    with open(path, "rb") as f:
        data = f.read()
    rd = _Reader(data)
    magic = rd.string()
    if magic == "PFE0":
        return _load_v0(rd)
    if magic in ("PFE1", "PFE2"):
        return _load_v1v2(rd, v2=(magic == "PFE2"))
    if magic == "PFE3":
        return _load_v3(rd)
    raise PfeError(f"not a PFE file (magic {magic!r})")


def _load_v0(rd: _Reader) -> Canvas:
    w = rd.u32()
    h = rd.u32()
    active = rd.u64()
    n = rd.u64()
    canvas = Canvas(width=w, height=h)
    for _ in range(n):
        name = rd.string()
        visible = rd.u8() == 1
        opacity = rd.f32()
        mode = rd.u8()
        flat = rd.bytes_vec()
        px = np.frombuffer(flat, np.uint8).reshape(h, w, 4).copy()
        canvas.layers.append(
            Layer(name=name, pixels=px, visible=visible, opacity=opacity,
                  blend_mode=BlendMode(mode if mode <= 24 else 0))
        )
    canvas.active_layer_index = min(active, max(len(canvas.layers) - 1, 0))
    return canvas


def _load_v1v2(rd: _Reader, v2: bool) -> Canvas:
    w = rd.u32()
    h = rd.u32()
    active = rd.u64()
    n = rd.u64()
    canvas = Canvas(width=w, height=h)
    for _ in range(n):
        name = rd.string()
        visible = rd.u8() == 1
        opacity = rd.f32()
        mode = rd.u8()
        layer_type = rd.u8() if v2 else 0
        n_chunks = rd.u64()
        chunks = []
        for _ in range(n_chunks):
            cx = rd.u32()
            cy = rd.u32()
            chunks.append((cx, cy, rd.bytes_vec()))
        text_blob = rd.option(rd.bytes_vec) if v2 else None
        px = _paste_chunks(w, h, chunks)
        layer = Layer(name=name, pixels=px, visible=visible, opacity=opacity,
                      blend_mode=BlendMode(mode if mode <= 24 else 0))
        if layer_type == 1:
            layer.content = "text"
            if text_blob:
                # our own JSON payload round-trips; reference-bincode text
                # payloads return None (accepted text-parity gap) and the
                # layer keeps its rasterized pixels
                from paintfe_tpu_torch.ops.text_layer import text_data_from_json

                layer.text_data = text_data_from_json(text_blob)
        canvas.layers.append(layer)
    canvas.active_layer_index = min(active, max(len(canvas.layers) - 1, 0))
    return canvas


# ---------------------------------------------------------------------------
# V3: folders + adjustment layers + deep pixels + HDR + metadata
# ---------------------------------------------------------------------------


def _write_adjustment(adj: AdjustmentLayerData) -> bytes:
    w = _Writer()
    w.u32(_ADJ_KINDS.index(AdjustmentKind(adj.kind)))
    k = AdjustmentKind(adj.kind)
    if k == AdjustmentKind.EXPOSURE:
        w.f32(adj.ev)
    elif k == AdjustmentKind.BRIGHTNESS_CONTRAST:
        w.f32(adj.brightness)
        w.f32(adj.contrast)
    elif k == AdjustmentKind.CHANNEL_MIXER:
        for row in (adj.red, adj.green, adj.blue, adj.alpha):
            for v in row:
                w.f32(v)
    return w.getvalue()


def _read_adjustment(data: bytes) -> AdjustmentLayerData:
    rd = _Reader(data)
    kind = _enum_tag(_ADJ_KINDS, rd.u32(), "adjustment kind")
    adj = AdjustmentLayerData(kind=kind)
    if kind == AdjustmentKind.EXPOSURE:
        adj.ev = rd.f32()
    elif kind == AdjustmentKind.BRIGHTNESS_CONTRAST:
        adj.brightness = rd.f32()
        adj.contrast = rd.f32()
    elif kind == AdjustmentKind.CHANNEL_MIXER:
        adj.red = tuple(rd.f32() for _ in range(4))
        adj.green = tuple(rd.f32() for _ in range(4))
        adj.blue = tuple(rd.f32() for _ in range(4))
        adj.alpha = tuple(rd.f32() for _ in range(4))
    return adj


def _write_deep(w: _Writer, deep: DeepRgbaBuffer):
    fmt = PixelFormat(deep.format)
    w.u32(_PIXEL_FORMATS.index(fmt))
    data = np.ascontiguousarray(deep.data)
    w.u64(data.size)
    w.buf.write(data.tobytes())


def _read_deep(rd: _Reader) -> DeepRgbaBuffer:
    fmt = _enum_tag(_PIXEL_FORMATS, rd.u32(), "pixel format")
    n = rd.u64()
    if fmt == PixelFormat.RGBA_U8:
        data = np.frombuffer(rd.take(n), np.uint8).copy()
    elif fmt in (PixelFormat.RGBA_U16, PixelFormat.RGBA_F16):
        data = np.frombuffer(rd.take(n * 2), "<u2").copy()
    else:
        data = np.frombuffer(rd.take(n * 4), "<f4").copy()
    return DeepRgbaBuffer(fmt, data)


def _write_hdr(w: _Writer, hdr: HdrMetadata):
    w.u8(1 if hdr.enabled else 0)
    for v in (hdr.max_luminance_nits, hdr.reference_white_nits):
        if v is None:
            w.u8(0)
        else:
            w.u8(1)
            w.f32(v)
    if hdr.transfer_function is None:
        w.u8(0)
    else:
        w.u8(1)
        w.string(hdr.transfer_function)


def _read_hdr(rd: _Reader) -> HdrMetadata:
    hdr = HdrMetadata(enabled=rd.u8() == 1)
    hdr.max_luminance_nits = rd.option(rd.f32)
    hdr.reference_white_nits = rd.option(rd.f32)
    hdr.transfer_function = rd.option(rd.string)
    return hdr


def _write_meta(w: _Writer, meta: ImageMetadata):
    for v in (meta.source_format, meta.source_name, meta.color_profile_name):
        if v is None:
            w.u8(0)
        else:
            w.u8(1)
            w.string(v)
    w.u64(len(meta.png_text_chunks))
    for key, val in meta.png_text_chunks:
        w.string(key)
        w.string(val)
    w.u64(0)  # raw_png_chunks (not preserved)


def _read_meta(rd: _Reader) -> ImageMetadata:
    meta = ImageMetadata()
    meta.source_format = rd.option(rd.string)
    meta.source_name = rd.option(rd.string)
    meta.color_profile_name = rd.option(rd.string)
    n = rd.u64()
    meta.png_text_chunks = [(rd.string(), rd.string()) for _ in range(n)]
    n_raw = rd.u64()
    for _ in range(n_raw):
        rd.bytes_vec()
    return meta


def _save_v3(canvas: Canvas, path: str):
    wtr = _Writer()
    wtr.string("PFE3")
    wtr.u32(canvas.width)
    wtr.u32(canvas.height)
    wtr.u64(canvas.active_layer_index)
    wtr.u64(len(canvas.folders))
    for f in canvas.folders:
        wtr.u64(f.id)
        wtr.string(f.name)
        wtr.u8(1 if f.visible else 0)
        wtr.u8(0 if f.expanded else 1)  # collapsed
        wtr.u8(0)  # insert_above_layer: None
        wtr.u8(0)  # color_index: None
    next_id = max([f.id for f in canvas.folders], default=0) + 1
    wtr.u64(next_id)
    wtr.u64(len(canvas.layers))
    for layer in canvas.layers:
        wtr.string(layer.name)
        wtr.u8(1 if layer.visible else 0)
        if layer.folder_id is None:
            wtr.u8(0)
        else:
            wtr.u8(1)
            wtr.u64(layer.folder_id)
        wtr.f32(layer.opacity)
        wtr.u8(int(layer.blend_mode))
        layer_type = {"raster": 0, "text": 1, "adjustment": 2}.get(layer.content, 0)
        wtr.u8(layer_type)
        chunks = list(_chunks_of(np.asarray(layer.pixels, np.uint8)))
        wtr.u64(len(chunks))
        for cx, cy, data in chunks:
            wtr.u32(cx)
            wtr.u32(cy)
            wtr.bytes_vec(data)
        if layer.content == "adjustment" and layer.adjustment is not None:
            wtr.u8(1)
            wtr.bytes_vec(_write_adjustment(layer.adjustment))
        elif layer.content == "text" and layer.text_data is not None:
            wtr.u8(1)
            wtr.bytes_vec(_text_payload(layer))
        else:
            wtr.u8(0)
        fmt = layer.pixel_format or PixelFormat.RGBA_U8
        wtr.u32(_PIXEL_FORMATS.index(PixelFormat(fmt)))
        _write_hdr(wtr, layer.hdr_metadata or HdrMetadata())
        _write_meta(wtr, layer.source_metadata or ImageMetadata())
        wtr.u32(1)  # WebpFrameCompression::Lossless
        if layer.deep_pixels is not None:
            wtr.u8(1)
            _write_deep(wtr, layer.deep_pixels)
        else:
            wtr.u8(0)
    with open(path, "wb") as f:
        f.write(wtr.getvalue())


def _load_v3(rd: _Reader) -> Canvas:
    w = rd.u32()
    h = rd.u32()
    active = rd.u64()
    canvas = Canvas(width=w, height=h)
    n_folders = rd.u64()
    for _ in range(n_folders):
        fid = rd.u64()
        name = rd.string()
        visible = rd.u8() == 1
        collapsed = rd.u8() == 1
        if rd.u8() == 1:
            rd.u64()  # insert_above_layer
        if rd.u8() == 1:
            rd.u8()  # color_index
        canvas.folders.append(
            LayerFolder(id=fid, name=name, visible=visible, expanded=not collapsed)
        )
    rd.u64()  # next_layer_folder_id
    n_layers = rd.u64()
    for _ in range(n_layers):
        name = rd.string()
        visible = rd.u8() == 1
        folder_id = rd.option(rd.u64)
        opacity = rd.f32()
        mode = rd.u8()
        layer_type = rd.u8()
        n_chunks = rd.u64()
        chunks = []
        for _ in range(n_chunks):
            cx = rd.u32()
            cy = rd.u32()
            chunks.append((cx, cy, rd.bytes_vec()))
        content_data = rd.option(rd.bytes_vec)
        fmt = _enum_tag(_PIXEL_FORMATS, rd.u32(), "pixel format")
        hdr = _read_hdr(rd)
        meta = _read_meta(rd)
        rd.u32()  # webp_frame_compression
        deep = rd.option(lambda: _read_deep(rd))
        layer = Layer(
            name=name, pixels=_paste_chunks(w, h, chunks), visible=visible,
            opacity=opacity, blend_mode=BlendMode(mode if mode <= 24 else 0),
            folder_id=folder_id,
            content={0: "raster", 1: "text", 2: "adjustment"}.get(layer_type, "raster"),
            pixel_format=fmt, hdr_metadata=hdr, source_metadata=meta,
            deep_pixels=deep,
        )
        if layer.content == "adjustment" and content_data:
            layer.adjustment = _read_adjustment(content_data)
        elif layer.content == "text" and content_data:
            from paintfe_tpu_torch.ops.text_layer import text_data_from_json

            layer.text_data = text_data_from_json(content_data)
        canvas.layers.append(layer)
    canvas.active_layer_index = min(active, max(len(canvas.layers) - 1, 0))
    return canvas
