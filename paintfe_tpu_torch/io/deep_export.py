"""High-bit-depth export: 16-bit PNG and 16/32-bit TIFF, the export half
of paintfe_tpu.io.deep_export.

Behavioral contract: src/io.rs — `prepare_export_image` picks the export
depth from the visible layers (:1413-1453): two lossless fast paths (an
adjustment-only stack over a deep base :1456-1523, a single exact deep layer
:1541-1585), then composite-based promotion (any HDR/F16/F32 layer -> f32,
any U16 layer -> u16 = u8*257).  `encode_prepared_and_write` (:1588-1631)
routes Rgba16 to 16-bit PNG/TIFF and RgbaF32 to float TIFF; everything else
downconverts (u16 -> (v+128)/257, f32 -> Reinhard when any channel > 1).
The composite runs on a torch device (Canvas.composite, K-composite on the
card).  The read half (16-bit PNG/TIFF inputs) is not yet ported.

The PNG and TIFF encoders are self-contained (PIL cannot write 16-bit
RGBA): PNG bit depth 16 color type 6 big-endian, TIFF little-endian with
none/LZW/deflate strips.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

from paintfe_tpu_torch.core.blend import BlendMode
from paintfe_tpu_torch.core.canvas import Canvas
from paintfe_tpu_torch.core.deep import PixelFormat, f16_bits_to_f32, reinhard_tone_map

f32 = np.float32


@dataclasses.dataclass
class PreparedExport:
    kind: str  # 'rgba8' | 'rgba16' | 'rgbaf32'
    width: int
    height: int
    data: np.ndarray  # u8 / u16 / f32, [H, W, 4]


def _deep_to_f32(deep, width: int, height: int) -> Optional[np.ndarray]:
    """DeepRgbaBuffer -> [H, W, 4] f32 in 0..1 (io.rs:1524-1540)."""
    if deep.data.size != width * height * 4:
        return None
    fmt = PixelFormat(deep.format)
    if fmt == PixelFormat.RGBA_U8:
        out = deep.data.astype(f32) / f32(255.0)
    elif fmt == PixelFormat.RGBA_U16:
        out = deep.data.astype(f32) / f32(65535.0)
    elif fmt == PixelFormat.RGBA_F16:
        out = f16_bits_to_f32(deep.data)
    else:
        out = deep.data.astype(f32)
    return out.reshape(height, width, 4)


def _visible_layers(canvas: Canvas):
    return [
        l for i, l in enumerate(canvas.layers) if canvas.layer_effectively_visible(i)
    ]


def _layer_is_plain_base(layer) -> bool:
    return (
        layer.content == "raster"
        and layer.opacity >= 0.999
        and layer.blend_mode == BlendMode.NORMAL
        and layer.mask is None
    )


def _deep_matches_preview(layer, w: int, h: int) -> bool:
    if layer.deep_pixels.data.size != w * h * 4:
        return False  # stale element count (canvas resized since sync)
    preview = layer.deep_pixels.to_rgba8(w, h)
    return bool(np.array_equal(preview, np.asarray(layer.pixels, np.uint8)))


def _adjusted_deep_export(canvas: Canvas) -> Optional[PreparedExport]:
    """Deep base + adjustment-only stack applied in f32 (io.rs:1456-1523)."""
    vis = _visible_layers(canvas)
    if len(vis) < 2:
        return None
    base = vis[0]
    if not _layer_is_plain_base(base) or base.deep_pixels is None:
        return None
    if not all(l.content == "adjustment" for l in vis[1:]):
        return None
    pixels = _deep_to_f32(base.deep_pixels, canvas.width, canvas.height)
    if pixels is None or not _deep_matches_preview(base, canvas.width, canvas.height):
        return None
    for layer in vis[1:]:
        if layer.adjustment is None:
            return None
        pixels = layer.adjustment.apply_to_f32_with_opacity(pixels, layer.opacity)
    hdr = getattr(base, "hdr_metadata", None)
    fmt = (PixelFormat(base.pixel_format) if base.pixel_format is not None
           else PixelFormat.RGBA_U8)
    if (hdr is not None and hdr.enabled) or fmt in (
        PixelFormat.RGBA_F16,
        PixelFormat.RGBA_F32,
    ):
        return PreparedExport("rgbaf32", canvas.width, canvas.height, pixels)
    if fmt == PixelFormat.RGBA_U16:
        u16 = np.floor(np.clip(pixels, 0.0, 1.0) * f32(65535.0) + f32(0.5)).astype(
            np.uint16
        )
        return PreparedExport("rgba16", canvas.width, canvas.height, u16)
    return None


def _exact_single_layer_deep_export(canvas: Canvas) -> Optional[PreparedExport]:
    """One visible deep layer, preview in sync: export losslessly
    (io.rs:1541-1585)."""
    vis = _visible_layers(canvas)
    if len(vis) != 1:
        return None
    layer = vis[0]
    if not _layer_is_plain_base(layer) or layer.deep_pixels is None:
        return None
    if not _deep_matches_preview(layer, canvas.width, canvas.height):
        return None
    fmt = PixelFormat(layer.deep_pixels.format)
    shape = (canvas.height, canvas.width, 4)
    if fmt == PixelFormat.RGBA_U8:
        return PreparedExport(
            "rgba8", canvas.width, canvas.height,
            layer.deep_pixels.data.astype(np.uint8).reshape(shape),
        )
    if fmt == PixelFormat.RGBA_U16:
        return PreparedExport(
            "rgba16", canvas.width, canvas.height,
            layer.deep_pixels.data.astype(np.uint16).reshape(shape),
        )
    if fmt == PixelFormat.RGBA_F16:
        return PreparedExport(
            "rgbaf32", canvas.width, canvas.height,
            f16_bits_to_f32(layer.deep_pixels.data).reshape(shape),
        )
    return PreparedExport(
        "rgbaf32", canvas.width, canvas.height,
        layer.deep_pixels.data.astype(f32).reshape(shape),
    )


def needs_deep_export(canvas: Canvas) -> bool:
    """True when any visible layer carries depth the u8 path would lose."""
    for i, l in enumerate(canvas.layers):
        if not canvas.layer_effectively_visible(i):
            continue
        if l.deep_pixels is not None:
            return True
        if l.pixel_format is not None and PixelFormat(l.pixel_format) != PixelFormat.RGBA_U8:
            return True
        hdr = getattr(l, "hdr_metadata", None)
        if hdr is not None and hdr.enabled:
            return True
    return False


def prepare_export_image(canvas: Canvas, device="cuda") -> PreparedExport:
    """Pick the widest export depth the document warrants (io.rs:1413-1453);
    a flatten runs on `device` (the card unless the caller passes "cpu")."""
    prep = _adjusted_deep_export(canvas)
    if prep is not None:
        return prep
    prep = _exact_single_layer_deep_export(canvas)
    if prep is not None:
        return prep

    composite = canvas.composite(device=device)
    vis = _visible_layers(canvas)

    def _fmt(l):
        return PixelFormat(l.pixel_format) if l.pixel_format is not None else PixelFormat.RGBA_U8

    if any(
        (getattr(l, "hdr_metadata", None) is not None and l.hdr_metadata.enabled)
        or _fmt(l) in (PixelFormat.RGBA_F16, PixelFormat.RGBA_F32)
        for l in vis
    ):
        return PreparedExport(
            "rgbaf32", canvas.width, canvas.height,
            composite.astype(f32) / f32(255.0),
        )
    if any(_fmt(l) == PixelFormat.RGBA_U16 for l in vis):
        return PreparedExport(
            "rgba16", canvas.width, canvas.height,
            composite.astype(np.uint16) * 257,
        )
    return PreparedExport("rgba8", canvas.width, canvas.height, composite)


def prepared_to_rgba8(prep: PreparedExport) -> np.ndarray:
    """Downconvert for 8-bit formats (io.rs:1371-1410): u16 rounds via
    (v+128)/257; f32 Reinhard-tone-maps any pixel with a channel > 1."""
    if prep.kind == "rgba8":
        return np.asarray(prep.data, np.uint8)
    if prep.kind == "rgba16":
        return ((prep.data.astype(np.uint32) + 128) // 257).astype(np.uint8)
    px = prep.data.astype(f32)
    over = (px[..., 0:3] > 1.0).any(axis=-1)
    # plain path: round(clamp(v)*255)
    plain = np.floor(np.clip(px, 0.0, 1.0) * f32(255.0) + f32(0.5)).astype(np.uint8)
    # Reinhard x/(1+x) at exposure 1.0 for HDR pixels — the shared parity
    # mirror of experimental.rs:59-70 (an inline copy here once drifted
    # from it; keep ONE implementation)
    toned = reinhard_tone_map(px, 1.0)
    return np.where(over[..., None], toned, plain)


# ---------------------------------------------------------------------------
# 16-bit PNG writer (bit depth 16, color type 6 RGBA, big-endian samples)
# ---------------------------------------------------------------------------


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png16(path, width: int, height: int, pixels: np.ndarray):
    """io.rs:1651-1668 — RGBA 16-bit PNG, filter 0 rows."""
    data = np.ascontiguousarray(pixels, dtype=">u2").reshape(height, width * 4)
    raw = bytearray()
    for row in data:
        raw.append(0)  # filter: None
        raw += row.tobytes()
    ihdr = struct.pack(">IIBBBBB", width, height, 16, 6, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_png_chunk(b"IHDR", ihdr))
        fh.write(_png_chunk(b"IDAT", zlib.compress(bytes(raw), 6)))
        fh.write(_png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# TIFF writer (little-endian, single strip, none/LZW/deflate)
# ---------------------------------------------------------------------------


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-flavor LZW: MSB-first bit packing, Clear=256, EOI=257, 9->12 bit
    codes with the TIFF 'early change' (width bumps one code early).
    Pure Python: slow on large strips (the JAX package has a C++ path)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf = 0
    bitcnt = 0
    width = 9

    def emit(code):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            bitcnt -= 8
            out.append((bitbuf >> bitcnt) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(CLEAR)
    w = b""
    for byte in data:
        c = bytes([byte])
        wc = w + c
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        # TIFF early change: the decoder grows its code width when its next
        # free slot hits 2^n - 1, which on the encoder side (one entry ahead)
        # lands exactly when next_code reaches 2^n.  Verified against libtiff.
        if next_code == (1 << width):
            if width < 12:
                width += 1
            else:
                emit(CLEAR)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                width = 9
        w = c
    if w:
        emit(table[w])
    emit(EOI)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _write_tiff(path, width: int, height: int, payload: bytes, *,
                bits: int, sample_format: int, compression: str):
    comp_tag = {"none": 1, "lzw": 5, "deflate": 8}[compression]
    if compression == "lzw":
        strip = _lzw_encode(payload)
    elif compression == "deflate":
        strip = zlib.compress(payload, 6)
    else:
        strip = payload

    entries = []  # (tag, type, count, value_or_offset_payload)
    extra = bytearray()
    header_size = 8
    n_tags = 12
    ifd_size = 2 + n_tags * 12 + 4
    data_start = header_size + ifd_size

    def short_arr(vals):
        return struct.pack("<%dH" % len(vals), *vals)

    def add(tag, typ, count, value_bytes, inline_ok):
        nonlocal extra
        if inline_ok and len(value_bytes) <= 4:
            entries.append((tag, typ, count, value_bytes.ljust(4, b"\0")))
        else:
            off = data_start + len(extra)
            entries.append((tag, typ, count, struct.pack("<I", off)))
            extra += value_bytes
            if len(extra) % 2:
                extra += b"\0"

    add(256, 4, 1, struct.pack("<I", width), True)          # ImageWidth
    add(257, 4, 1, struct.pack("<I", height), True)         # ImageLength
    add(258, 3, 4, short_arr([bits] * 4), False)            # BitsPerSample
    add(259, 3, 1, struct.pack("<H", comp_tag), True)       # Compression
    add(262, 3, 1, struct.pack("<H", 2), True)              # Photometric RGB
    add(277, 3, 1, struct.pack("<H", 4), True)              # SamplesPerPixel
    add(278, 4, 1, struct.pack("<I", height), True)         # RowsPerStrip
    add(338, 3, 1, struct.pack("<H", 2), True)              # ExtraSamples: alpha
    add(339, 3, 4, short_arr([sample_format] * 4), False)   # SampleFormat
    add(284, 3, 1, struct.pack("<H", 1), True)              # PlanarConfig chunky
    strip_off = data_start + len(extra)
    add(273, 4, 1, struct.pack("<I", strip_off), True)      # StripOffsets
    add(279, 4, 1, struct.pack("<I", len(strip)), True)     # StripByteCounts
    assert len(entries) == n_tags

    with open(path, "wb") as fh:
        fh.write(b"II*\0" + struct.pack("<I", 8))
        fh.write(struct.pack("<H", n_tags))
        for tag, typ, count, val in sorted(entries):
            fh.write(struct.pack("<HHI", tag, typ, count) + val)
        fh.write(struct.pack("<I", 0))  # next IFD
        fh.write(bytes(extra))
        fh.write(strip)


def write_tiff16(path, width: int, height: int, pixels: np.ndarray,
                 compression: str = "none"):
    """io.rs:1670-1706 — RGBA 16-bit TIFF with the CLI's compression modes."""
    payload = np.ascontiguousarray(pixels, dtype="<u2").tobytes()
    _write_tiff(path, width, height, payload, bits=16, sample_format=1,
                compression=compression)


def write_tiff_f32(path, width: int, height: int, pixels: np.ndarray):
    """io.rs:1708-1720 — RGBA float32 TIFF (uncompressed)."""
    payload = np.ascontiguousarray(pixels, dtype="<f4").tobytes()
    _write_tiff(path, width, height, payload, bits=32, sample_format=3,
                compression="none")


def encode_prepared_and_write(prep: PreparedExport, path, fmt: str,
                              quality: int = 90, tiff_compression: str = "none",
                              webp_lossless: bool = True):
    """Route deep exports to the 16/32-bit writers (io.rs:1588-1631)."""
    from paintfe_tpu_torch.io import codecs

    fmt = fmt.lower()
    if prep.kind == "rgba16" and fmt == "png":
        return write_png16(path, prep.width, prep.height, prep.data)
    if prep.kind == "rgba16" and fmt == "tiff":
        return write_tiff16(path, prep.width, prep.height, prep.data,
                            tiff_compression)
    if prep.kind == "rgbaf32" and fmt == "tiff":
        return write_tiff_f32(path, prep.width, prep.height, prep.data)
    return codecs.save_image(
        prepared_to_rgba8(prep), path, fmt, quality=quality,
        webp_lossless=webp_lossless, tiff_compression=tiff_compression,
    )
