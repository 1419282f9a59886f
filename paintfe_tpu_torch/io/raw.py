"""RAW camera ingestion (the port of paintfe_tpu.io.raw): DNG, Canon CR2,
Nikon NEF/NRW, Sony ARW, Pentax PEF, Samsung SRW, Olympus ORF and
Panasonic RW2/RWL, function for function under the JAX package's names.

The reference reads these families through the `rawloader` crate
(src/io.rs:36-80).  Supported, as in the JAX package:

- **DNG**: uncompressed (Compression=1), LZW (5), lossless-JPEG (7),
  deflate (8) and lossy baseline-JPEG (34892) raw IFDs, floating-point
  samples (SampleFormat=3, fp16/24/32 with the byte-plane fp predictors
  3/34894/34895), strips or tiles, linear RGB/gray or 2x2 CFA mosaics,
  per-plane black levels (BlackLevelRepeatDim), ActiveArea crop and the
  ColorMatrix1 camera->sRGB transform.
- **CR2**: one lossless-JPEG stream (Compression=6) in Canon's vertical
  slices (tag 0xc640), SensorInfo crop and masked-border black level.
- **NEF**: plain 16-bit or packed 12/14-bit uncompressed raw SubIFDs.
- **ARW/PEF/SRW/ORF**: the shared TIFF/EP CFA shape (ORF with its RO/SR
  magics), plain or MSB-packed strips, and Sony's lossless SOF3 mode.
- **RW2/RWL**: Panasonic's magic-85 container, unpacked 16-bit samples.

Proprietary entropy codings (CR3, RAF, Nikon-compressed NEF, Sony ARW2
curve, Pentax huffman, Olympus compressed, Panasonic sync-coded) raise a
clear RawError.

Where each step runs:

- The container parse and the entropy decode run on the host: numpy, and
  the port's C++ through ctypes (native/ljpeg.cpp, native/jpegdct.cpp, the
  LZW decode of native/bytecodec.cpp).  A failed g++ build raises.
- The develop stage runs in torch on `device` (the card unless the caller
  asks for the CPU): `_normalize_levels` (black subtract, white
  normalize), the white-balance gains (site maps built from coordinates
  only) and `_demosaic_bilinear`.  Its arithmetic is IEEE f32 `+ - * /`,
  min/max and selects, in the JAX package's order: the demosaic's nine
  taps are summed one by one from zeros (weights 1, 2 and 4: exact
  products; never a convolution), and a divide by a host scalar goes
  through utils/quant.ieee_div.  The linear RGB comes back to the host.
- The colour matrix (`_apply_color_matrix`), the sRGB encode and the u8
  step (`_finish_srgb`) stay host numpy, the JAX package's own calls: the
  matrix product is numpy's matmul (the host BLAS's summation order and
  FMA use), and the sRGB curve takes numpy's f32 `np.power` of continuous
  values per pixel, which no device function reproduces and which the
  transcendental rule keeps off the card.  The same call on the same host
  gives the JAX package's bytes.

Every decoder takes an optional StageTimer (utils/profiling) whose stages
name these steps: decode, upload, develop, download, matrix, srgb, u8.
"""

from __future__ import annotations

import contextlib
import ctypes
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paintfe_tpu_torch.utils.quant import ieee_div

f32 = np.float32

# TIFF tag ids
T_NEW_SUBFILE_TYPE = 254
T_WIDTH = 256
T_HEIGHT = 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_MAKE = 271
T_STRIP_OFFSETS = 273
T_SPP = 277
T_ROWS_PER_STRIP = 278
T_STRIP_COUNTS = 279
T_PLANAR = 284
T_PREDICTOR = 317
T_SAMPLE_FORMAT = 339
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_COUNTS = 325
T_SUB_IFDS = 330
T_CFA_DIM = 33421
T_CFA_PATTERN = 33422
T_EXIF_IFD = 34665
T_MAKER_NOTE = 37500
T_DNG_VERSION = 50706
T_BLACK_REPEAT = 50713
T_BLACK_LEVEL = 50714
T_WHITE_LEVEL = 50717
T_COLOR_MATRIX1 = 50721
T_AS_SHOT_NEUTRAL = 50728
T_ACTIVE_AREA = 50829
T_CR2_SLICES = 50752  # 0xc640: Canon raw slice widths [n, wa, wb]

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8}


class RawError(Exception):
    pass


def _read_values(blob: bytes, end: str, typ: int, count: int,
                 value_field: bytes):
    size = _TYPE_SIZES.get(typ)
    if size is None:
        return None
    total = size * count
    if total <= 4:
        data = value_field[:total]
    else:
        (off,) = struct.unpack(end + "I", value_field)
        data = blob[off:off + total]
    if typ == 2:  # ASCII: NUL-terminated string (Make/Model and friends)
        return [data.split(b"\0", 1)[0].decode("ascii", errors="replace")]
    if typ in (1, 6, 7):
        return list(data)
    if typ == 3:
        return list(struct.unpack(end + f"{count}H", data))
    if typ == 8:
        return list(struct.unpack(end + f"{count}h", data))
    if typ in (4, 9):
        return list(struct.unpack(end + f"{count}{'I' if typ == 4 else 'i'}", data))
    if typ in (5, 10):
        fmtc = "I" if typ == 5 else "i"
        raw = struct.unpack(end + f"{2 * count}{fmtc}", data)
        return [raw[2 * i] / raw[2 * i + 1] if raw[2 * i + 1] else 0.0
                for i in range(count)]
    if typ == 11:
        return list(struct.unpack(end + f"{count}f", data))
    if typ == 12:
        return list(struct.unpack(end + f"{count}d", data))
    return None


def _parse_ifd(blob: bytes, end: str, off: int) -> Tuple[Dict[int, list], int]:
    (n_tags,) = struct.unpack(end + "H", blob[off:off + 2])
    tags = {}
    for k in range(n_tags):
        base = off + 2 + k * 12
        tag, typ, count = struct.unpack(end + "HHI", blob[base:base + 8])
        vals = _read_values(blob, end, typ, count, blob[base + 8:base + 12])
        if vals is not None:
            tags[tag] = vals
    (nxt,) = struct.unpack(end + "I", blob[off + 2 + n_tags * 12:
                                           off + 2 + n_tags * 12 + 4])
    return tags, nxt


def _all_ifds(blob: bytes,
              magics: Tuple[int, ...] = (42,)) -> Tuple[str, List[Dict[int, list]]]:
    if blob[:2] == b"II":
        end = "<"
    elif blob[:2] == b"MM":
        end = ">"
    else:
        raise RawError("not a TIFF container")
    (magic,) = struct.unpack(end + "H", blob[2:4])
    if magic not in magics:
        raise RawError("not a TIFF container (bad magic)")
    (off,) = struct.unpack(end + "I", blob[4:8])
    ifds: List[Dict[int, list]] = []
    seen = set()
    stack = [off]
    while stack:
        o = stack.pop()
        if not o or o in seen or o + 2 > len(blob):
            continue
        seen.add(o)
        tags, nxt = _parse_ifd(blob, end, o)
        ifds.append(tags)
        if nxt:
            stack.append(nxt)
        for sub in tags.get(T_SUB_IFDS, []):
            stack.append(sub)
    return end, ifds


def _pick_raw_ifd(ifds: List[Dict[int, list]]) -> Dict[int, list]:
    """The raw image: NewSubfileType==0 if tagged, else the largest area."""
    def area(t):
        return t.get(T_WIDTH, [0])[0] * t.get(T_HEIGHT, [0])[0]

    candidates = [t for t in ifds if t.get(T_NEW_SUBFILE_TYPE, [0])[0] == 0
                  and area(t) > 0]
    if not candidates:
        candidates = [t for t in ifds if area(t) > 0]
    if not candidates:
        raise RawError("no image IFD found")
    return max(candidates, key=area)


# ---------------------------------------------------------------------------
# Lossless-JPEG entropy decode (native)
# ---------------------------------------------------------------------------

def ljpeg_decode(stream: bytes) -> np.ndarray:
    """Decode one SOF3 lossless-JPEG stream to a (lines, samples) u16 array
    (components interleaved along the row) via the native decoder."""
    return ljpeg_decode_full(stream)[0]


def ljpeg_decode_full(stream: bytes) -> Tuple[np.ndarray, int]:
    """Like ljpeg_decode but also returns the SOF3 sample precision (the
    authoritative bit depth: CR2 normalization must not guess it from
    pixel values, which misreads dark 14-bit frames as 12-bit)."""
    from paintfe_tpu_torch import native

    lib = native.load()  # a failed build raises with g++'s message
    buf = (ctypes.c_uint8 * len(stream)).from_buffer_copy(stream)
    info = (ctypes.c_uint32 * 4)()
    rc = lib.ljpeg_info(buf, len(stream), info)
    if rc != 0:
        raise RawError(_LJPEG_ERRORS.get(rc, f"LJPEG error {rc}"))
    w, h, nc, prec = (int(v) for v in info)
    out = np.zeros(h * w * nc, np.uint16)
    rc = lib.ljpeg_decode(
        buf, len(stream),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size)
    if rc != 0:
        raise RawError(_LJPEG_ERRORS.get(rc, f"LJPEG error {rc}"))
    return out.reshape(h, w * nc), prec


_LJPEG_ERRORS = {
    -1: "malformed lossless-JPEG stream",
    -2: "unsupported lossless-JPEG feature (lossy SOF / sampling != 1x1 / "
        "mid-row restart interval)",
    -3: "truncated lossless-JPEG entropy data",
    -4: "lossless-JPEG output capacity mismatch",
}


# ---------------------------------------------------------------------------
# Sample plane assembly (strips / tiles, uncompressed / LJPEG)
# ---------------------------------------------------------------------------

def _read_samples(blob: bytes, end: str, tags: Dict[int, list]) -> np.ndarray:
    w = tags[T_WIDTH][0]
    h = tags[T_HEIGHT][0]
    bits = tags.get(T_BITS, [16])[0]
    spp = tags.get(T_SPP, [1])[0]
    comp = tags.get(T_COMPRESSION, [1])[0]
    if tags.get(T_PLANAR, [1])[0] != 1:
        raise RawError("planar DNG layout is not supported")
    tiled = T_TILE_OFFSETS in tags

    if tags.get(T_SAMPLE_FORMAT, [1])[0] == 3:  # IEEE floating point
        return _read_fp_samples(blob, end, tags, w, h, spp, bits, comp, tiled)
    if comp == 7:
        return _read_ljpeg_samples(blob, tags, w, h, spp, tiled)
    if comp in (5, 8):
        return _read_compressed_samples(blob, end, tags, w, h, spp, bits,
                                        comp, tiled)
    if comp == 34892:
        return _read_lossy_jpeg_samples(blob, tags, w, h, spp, bits, tiled)
    if comp != 1:
        raise RawError(f"DNG compression {comp} is not supported "
                       "(1 uncompressed, 5 LZW, 7 lossless JPEG, 8 deflate, "
                       "34892 lossy JPEG)")
    if bits not in (8, 16):
        raise RawError(f"{bits}-bit uncompressed DNG samples are not supported")
    dt = np.dtype(("<" if end == "<" else ">") + ("u2" if bits == 16 else "u1"))

    if tiled:
        return _assemble_tiles(
            blob, tags, w, h, spp,
            lambda payload, tw, tl: np.frombuffer(
                payload, dt, count=tw * tl * spp
            ).astype(np.float32).reshape(tl, tw * spp))
    offsets = tags.get(T_STRIP_OFFSETS)
    counts = tags.get(T_STRIP_COUNTS)
    if not offsets or not counts:
        raise RawError("DNG raw IFD has neither strip nor tile offsets")
    payload = b"".join(blob[o:o + c] for o, c in zip(offsets, counts))
    need = w * h * spp
    arr = np.frombuffer(payload, dt, count=need).astype(np.float32)
    return arr.reshape(h, w, spp) if spp > 1 else arr.reshape(h, w)


def _read_compressed_samples(blob, end, tags, w, h, spp, bits, comp,
                             tiled) -> np.ndarray:
    """Compression=5 (TIFF LZW) / =8 (deflate) strips or tiles, with
    TIFF Predictor 2 (per-row horizontal differencing) support."""
    import zlib

    from paintfe_tpu_torch.io.deep_export import _lzw_decode

    if bits not in (8, 16):
        raise RawError(f"{bits}-bit compressed DNG samples are not supported")
    predictor = tags.get(T_PREDICTOR, [1])[0]
    if predictor not in (1, 2):
        raise RawError(f"TIFF predictor {predictor} is not supported")
    dt = np.dtype(("<" if end == "<" else ">") + ("u2" if bits == 16 else "u1"))
    native_t = np.uint16 if bits == 16 else np.uint8

    def decode_seg(payload: bytes, seg_w: int, seg_rows: int) -> np.ndarray:
        try:
            rawb = zlib.decompress(payload) if comp == 8 else _lzw_decode(payload)
        except Exception as e:
            raise RawError(f"corrupt compressed DNG segment: {e}")
        need = seg_rows * seg_w * spp
        arr = np.frombuffer(rawb, dt, count=need).astype(native_t)
        arr = arr.reshape(seg_rows, seg_w * spp)
        if predictor == 2:
            # horizontal differencing per sample channel, modular add
            arr = np.cumsum(arr.reshape(seg_rows, seg_w, spp), axis=1,
                            dtype=native_t).reshape(seg_rows, seg_w * spp)
        return arr.astype(np.float32)

    if tiled:
        return _assemble_tiles(blob, tags, w, h, spp, decode_seg)
    return _assemble_strips(blob, tags, w, h, spp, decode_seg)


def _fp24_bits_to_f32(u: np.ndarray) -> np.ndarray:
    """DNG 24-bit float (1 sign / 7 exponent bias-63 / 16 mantissa) to f32.
    Every fp24 value is exactly representable in fp32 (public DNG spec
    ch.3 'Floating Point Data'), so this conversion is lossless."""
    u = u.astype(np.uint32)
    sign = (u >> 23) & 1
    exp = (u >> 16) & 0x7F
    mant = u & 0xFFFF
    out = np.zeros(u.shape, np.uint32)
    normal = (exp > 0) & (exp < 0x7F)
    out = np.where(normal, (sign << 31) | ((exp + 64) << 23) | (mant << 7), out)
    out = np.where(exp == 0x7F,  # Inf / NaN
                   (sign << 31) | np.uint32(0xFF << 23) | (mant << 7), out)
    den = (exp == 0) & (mant > 0)
    if den.any():  # fp24 denormals: mant * 2^-78, a normal fp32 value
        denbits = (mant.astype(np.float64) * 2.0 ** -78).astype(
            np.float32).view(np.uint32)
        out = np.where(den, (sign << 31) | denbits, out)
    out = np.where((exp == 0) & (mant == 0), sign << 31, out)
    return out.view(np.float32)


def _read_fp_samples(blob, end, tags, w, h, spp, bits, comp,
                     tiled) -> np.ndarray:
    """SampleFormat=3: IEEE floating-point DNG samples (fp16/24/32), plain
    or deflate/LZW-compressed, with TIFF Predictor 3 (byte-plane floating
    point differencing) and the DNG 1.4 X2/X4 variants 34894/34895.

    Layout per the public TIFF/DNG specs (libtiff fpAcc is the canonical
    decoder shape): with an fp predictor each ROW is stored as
    bytes-per-sample big-endian byte PLANES (all MSBs first), delta-coded
    byte-wise at stride spp x (1|2|4); without it, samples are plain IEEE
    values in container byte order."""
    import zlib

    from paintfe_tpu_torch.io.deep_export import _lzw_decode

    if bits not in (16, 24, 32):
        raise RawError(f"{bits}-bit floating-point DNG samples are not "
                       "supported (fp16/fp24/fp32)")
    if comp not in (1, 5, 8):
        raise RawError(f"floating-point DNG compression {comp} is not "
                       "supported (1 uncompressed, 5 LZW, 8 deflate)")
    predictor = tags.get(T_PREDICTOR, [1])[0]
    if predictor not in (1, 3, 34894, 34895):
        raise RawError(f"TIFF predictor {predictor} is not supported for "
                       "floating-point samples")
    bps = bits // 8
    stride = spp * {1: 1, 3: 1, 34894: 2, 34895: 4}[predictor]

    def to_f32(be_bytes: np.ndarray) -> np.ndarray:
        # be_bytes: (..., bps) most-significant byte first
        if bits == 32:
            return be_bytes.reshape(be_bytes.shape[:-1] + (bps,)).copy().view(
                ">f4")[..., 0].astype(np.float32)
        if bits == 16:
            return be_bytes.copy().view(">f2")[..., 0].astype(np.float32)
        u = ((be_bytes[..., 0].astype(np.uint32) << 16)
             | (be_bytes[..., 1].astype(np.uint32) << 8)
             | be_bytes[..., 2])
        return _fp24_bits_to_f32(u)

    def decode_seg(payload: bytes, seg_w: int, seg_rows: int) -> np.ndarray:
        if comp == 8:
            try:
                rawb = zlib.decompress(payload)
            except Exception as e:
                raise RawError(f"corrupt deflate DNG segment: {e}")
        elif comp == 5:
            rawb = _lzw_decode(payload)
        else:
            rawb = payload
        wc = seg_w * spp
        need = seg_rows * wc * bps
        if len(rawb) < need:
            raise RawError("floating-point DNG segment is truncated")
        arr = np.frombuffer(rawb, np.uint8, count=need).reshape(
            seg_rows, wc * bps)
        if predictor == 1:
            sample_bytes = arr.reshape(seg_rows, wc, bps)
            if end == "<":  # container order -> big-endian byte order
                sample_bytes = sample_bytes[..., ::-1]
            return to_f32(sample_bytes).reshape(seg_rows, wc)
        # undo per-row byte differencing at `stride`, then de-plane
        acc = arr.copy()
        for off in range(stride):
            np.cumsum(acc[:, off::stride], axis=1, dtype=np.uint8,
                      out=acc[:, off::stride])
        planes = acc.reshape(seg_rows, bps, wc)
        return to_f32(planes.transpose(0, 2, 1)).reshape(seg_rows, wc)

    if tiled:
        return _assemble_tiles(blob, tags, w, h, spp, decode_seg)
    return _assemble_strips(blob, tags, w, h, spp, decode_seg)


def jpegdct_decode(stream: bytes) -> np.ndarray:
    """Decode one baseline-DCT (SOF0/SOF1, 8-bit) JPEG stream to a
    (lines, samples) u8 array, components interleaved along the row and
    returned RAW (no color transform — DNG LinearRaw semantics), via the
    native decoder (native/jpegdct.cpp)."""
    from paintfe_tpu_torch import native

    lib = native.load()  # a failed build raises with g++'s message
    buf = (ctypes.c_uint8 * len(stream)).from_buffer_copy(stream)
    info = (ctypes.c_uint32 * 3)()
    rc = lib.jpegdct_info(buf, len(stream), info)
    if rc != 0:
        raise RawError(_JPEGDCT_ERRORS.get(rc, f"JPEG error {rc}"))
    w, h, nc = (int(v) for v in info)
    out = np.zeros(h * w * nc, np.uint8)
    rc = lib.jpegdct_decode(
        buf, len(stream),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
    if rc != 0:
        raise RawError(_JPEGDCT_ERRORS.get(rc, f"JPEG error {rc}"))
    return out.reshape(h, w * nc)


_JPEGDCT_ERRORS = {
    -1: "malformed baseline-JPEG stream",
    -2: "unsupported JPEG feature (progressive / arithmetic / 12-bit / "
        "subsampled)",
    -3: "truncated baseline-JPEG entropy data",
    -4: "baseline-JPEG output capacity mismatch",
}


def _read_lossy_jpeg_samples(blob, tags, w, h, spp, bits,
                             tiled) -> np.ndarray:
    """Compression=34892 (DNG lossy JPEG): every strip/tile is an
    independent 8-bit baseline-DCT JPEG stream; sample values are used
    directly (LinearRaw — the stream carries no YCbCr transform)."""
    if bits != 8:
        raise RawError("lossy-JPEG DNG must be 8-bit")

    def decode_seg(payload, seg_w, seg_rows):
        dec = jpegdct_decode(payload)
        if dec.size != seg_rows * seg_w * spp:
            raise RawError(
                f"lossy-JPEG segment decodes to {dec.size} samples, "
                f"expected {seg_rows * seg_w * spp}")
        return dec.astype(np.float32).reshape(seg_rows, seg_w * spp)

    if tiled:
        return _assemble_tiles(blob, tags, w, h, spp, decode_seg)
    return _assemble_strips(blob, tags, w, h, spp, decode_seg)


def _read_ljpeg_samples(blob: bytes, tags, w, h, spp, tiled) -> np.ndarray:
    """Compression=7: every strip/tile is an independent SOF3 stream whose
    flattened sample order equals the sensor raster order (DNG spec ch.3:
    components interleave along the row)."""

    def decode_seg(payload, seg_w, seg_rows):
        dec = ljpeg_decode(payload)
        if dec.size != seg_rows * seg_w * spp:
            raise RawError(
                f"LJPEG segment decodes to {dec.size} samples, expected "
                f"{seg_rows * seg_w * spp}")
        return dec.reshape(-1).astype(np.float32).reshape(
            seg_rows, seg_w * spp)

    if tiled:
        return _assemble_tiles(blob, tags, w, h, spp, decode_seg)
    return _assemble_strips(blob, tags, w, h, spp, decode_seg)


def _assemble_strips(blob, tags, w, h, spp, decode_fn) -> np.ndarray:
    """Strip walk shared by every per-segment decoder: decode_fn(payload,
    seg_w, seg_rows) -> (seg_rows, seg_w*spp) f32."""
    offsets = tags.get(T_STRIP_OFFSETS)
    counts = tags.get(T_STRIP_COUNTS)
    if not offsets or not counts:
        raise RawError("DNG raw IFD has neither strip nor tile offsets")
    rows_per = tags.get(T_ROWS_PER_STRIP, [h])[0] or h
    out = np.zeros((h, w * spp), np.float32)
    y = 0
    for o, c in zip(offsets, counts):
        rows = min(rows_per, h - y)
        if rows <= 0:
            break
        out[y:y + rows] = decode_fn(blob[o:o + c], w, rows)
        y += rows
    if y < h:
        raise RawError("DNG strips cover fewer rows than ImageLength")
    return out.reshape(h, w, spp) if spp > 1 else out


def _assemble_tiles(blob, tags, w, h, spp, decode_fn) -> np.ndarray:
    """Tiles are stored left-to-right, top-to-bottom, each padded to the
    full TileWidth x TileLength; edge tiles are cropped on placement."""
    tw = tags.get(T_TILE_WIDTH, [0])[0]
    tl = tags.get(T_TILE_LENGTH, [0])[0]
    offsets = tags.get(T_TILE_OFFSETS, [])
    counts = tags.get(T_TILE_COUNTS, [])
    if tw <= 0 or tl <= 0 or not offsets or len(offsets) != len(counts):
        raise RawError("malformed tiled DNG (tile geometry/offsets)")
    tiles_x = (w + tw - 1) // tw
    tiles_y = (h + tl - 1) // tl
    if len(offsets) < tiles_x * tiles_y:
        raise RawError("tiled DNG is missing tiles")
    out = np.zeros((h, w * spp), np.float32)
    i = 0
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            tile = decode_fn(blob[offsets[i]:offsets[i] + counts[i]], tw, tl)
            i += 1
            y0 = ty * tl
            rows = min(tl, h - y0)
            cols = min(tw, w - tx * tw) * spp
            out[y0:y0 + rows, tx * tw * spp:tx * tw * spp + cols] = \
                tile[:rows, :cols]
    return out.reshape(h, w, spp) if spp > 1 else out


# ---------------------------------------------------------------------------
# The develop stage on `device`, and the host's sRGB steps
# ---------------------------------------------------------------------------

def _stage(timer, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


def _upload(data: np.ndarray, device) -> torch.Tensor:
    """The host's f32 samples on `device`."""
    return torch.from_numpy(np.require(data, np.float32, ["C", "W"])).to(device)


def _download(t: torch.Tensor) -> np.ndarray:
    """A device result on the host; the copy has completed on return, so
    host numpy may read it at once (a prefetch thread included)."""
    return t.cpu().numpy()


def _tile_map(cell: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """`cell` repeated over an [h, w] image: cell[y % ch, x % cw] at
    (y, x), built on `device` from the small host array (a site map: the
    CFA colour, the gain or the black level of each pixel)."""
    t = torch.from_numpy(np.ascontiguousarray(cell)).to(device)
    if h == 0 or w == 0:  # an empty raster: the cell may be empty too
        return t.new_empty((h, w))
    ch, cw = cell.shape
    return t.repeat((h + ch - 1) // ch, (w + cw - 1) // cw)[:h, :w]


def _site_gains(gains: np.ndarray, pattern: np.ndarray, h: int,
                w: int, device) -> torch.Tensor:
    """gains[pattern[ys % 2, xs % 2]] on `device`.  The 2x2 cell is indexed
    on the host over the sites an h x w image has, so a pattern entry
    outside `gains` raises IndexError exactly where the JAX package's full
    map does."""
    return _tile_map(gains[pattern[:min(h, 2), :min(w, 2)]], h, w, device)


def _apply_gains(norm: torch.Tensor, gains: np.ndarray,
                 pattern: np.ndarray) -> torch.Tensor:
    """np.clip(norm * gains[pattern[ys % 2, xs % 2]], 0, 1) on norm's
    device, for a one-sample-per-pixel mosaic."""
    if norm.dim() != 2:
        # numpy refuses the broadcast, or the demosaic then does
        raise ValueError(f"a CFA mosaic needs one sample per pixel, got "
                         f"shape {tuple(norm.shape)}")
    h, w = norm.shape
    return torch.clamp(norm * _site_gains(gains, pattern, h, w, norm.device), 0.0, 1.0)


def _srgb_encode(linear: np.ndarray) -> np.ndarray:
    linear = np.clip(linear, 0.0, 1.0)
    lo = linear * f32(12.92)
    hi = f32(1.055) * np.power(linear, f32(1.0 / 2.4)) - f32(0.055)
    return np.where(linear <= f32(0.0031308), lo, hi)


_TAPS = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def _demosaic_bilinear(mosaic: torch.Tensor, pattern: np.ndarray) -> torch.Tensor:
    """[H, W] normalized CFA -> [H, W, 3] via normalized 3x3 interpolation,
    on mosaic's device.  Each 3x3 sum adds its nine taps one by one to
    zeros, dy-major, over an edge-replicated copy, as the JAX package's
    conv3 does; measured samples pass through at their own sites."""
    if mosaic.dim() != 2:
        raise ValueError(f"the demosaic takes an [H, W] mosaic, got shape "
                         f"{tuple(mosaic.shape)}")
    h, w = mosaic.shape
    if h == 0 or w == 0:  # np.pad's refusal, word for word
        raise ValueError(f"can't extend empty axis {0 if h == 0 else 1} using modes other "
                         "than 'constant' or 'empty'")
    cfa_idx = _tile_map(np.asarray(pattern, np.int32), h, w, mosaic.device)

    def conv3(a):
        p = torch.nn.functional.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        out = torch.zeros_like(a)
        for dy in range(3):
            for dx in range(3):
                out += _TAPS[dy][dx] * p[dy:dy + h, dx:dx + w]
        return out

    planes = []
    for c in range(3):
        site = cfa_idx == c
        mask = site.to(torch.float32)
        num = conv3(mosaic * mask)
        den = conv3(mask)
        interp = num / torch.clamp(den, min=1e-9)
        planes.append(torch.where(site, mosaic, interp))
    return torch.stack(planes, dim=-1)


def _guarded(family: str, decode, path, device) -> np.ndarray:
    """decode(blob, device) on the file's bytes: truncated or
    malformed containers surface as RawError, so the CLI's per-file
    keep-going handling applies (not a crash)."""
    from paintfe_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    with open(path, "rb") as fh:
        blob = fh.read()
    try:
        return decode(blob, device)
    except RawError:
        raise
    except (struct.error, KeyError, ValueError, IndexError) as e:
        raise RawError(f"malformed {family}: {type(e).__name__}: {e}")


def load_dng(path, device="cuda") -> np.ndarray:
    """Decode a DNG into RGBA u8 [H, W, 4], developed on `device`."""
    return _guarded("DNG", _decode_dng, path, device)


def _decode_dng(blob: bytes, device, timer=None) -> np.ndarray:
    return _finish_raw(*_develop_dng(blob, device, timer), timer)


def _develop_dng(blob: bytes, device, timer=None):
    """The container and entropy decode on the host, then the develop stage
    on `device`: (linear RGB on the host, ColorMatrix1 or None)."""
    with _stage(timer, "decode"):
        end, ifds = _all_ifds(blob)
        if not any(T_DNG_VERSION in t for t in ifds):
            # Plain TIFFs also land here via the normal codec; be explicit.
            raise RawError("no DNGVersion tag — not a DNG")
        tags = _pick_raw_ifd(ifds)
        data = _read_samples(blob, end, tags)
        bits = tags.get(T_BITS, [16])[0]
        photometric = tags.get(T_PHOTOMETRIC, [1])[0]

        # ActiveArea = [top, left, bottom, right]; CFAPattern is defined
        # relative to the active-area origin (DNG spec), so crop first.
        area = tags.get(T_ACTIVE_AREA)
        if area and len(area) == 4:
            top, left, bottom, right = (int(v) for v in area)
            if not (0 <= top < bottom <= data.shape[0]
                    and 0 <= left < right <= data.shape[1]):
                raise RawError("DNG ActiveArea outside image bounds")
            data = data[top:bottom, left:right]
    with _stage(timer, "upload"):
        samples = _upload(data, device)
    with _stage(timer, "develop"):
        norm = _normalize_levels(samples, tags, bits)
        if photometric == 32803:  # CFA mosaic
            dim = tags.get(T_CFA_DIM, [2, 2])
            pat = tags.get(T_CFA_PATTERN)
            if pat is None or dim[0] != 2 or dim[1] != 2:
                raise RawError("only 2x2 CFA patterns are supported")
            pattern = np.array(pat, np.int32).reshape(2, 2)
            neutral = tags.get(T_AS_SHOT_NEUTRAL, [1.0, 1.0, 1.0])
            wb = np.array([1.0 / max(n, 1e-6) for n in neutral], np.float32)
            wb = wb / max(wb[1], 1e-6)  # green-normalized camera multipliers
            rgb = _demosaic_bilinear(_apply_gains(norm, wb, pattern), pattern)
        elif photometric == 34892 or photometric == 2:  # LinearRaw / RGB
            if data.ndim != 3 or data.shape[2] < 3:
                raise RawError("linear DNG without 3 samples per pixel")
            rgb = norm  # the first three samples are taken on the host
        elif photometric == 1:  # linear grayscale
            rgb = norm[..., None].expand(*norm.shape, 3).contiguous()
        else:
            raise RawError(f"DNG photometric interpretation {photometric} "
                           "is not supported")
    with _stage(timer, "download"):
        rgb = _download(rgb)
    if photometric in (34892, 2):
        # the JAX package's view norm[..., :3], so the host's matmul sees
        # the same memory layout
        rgb = rgb[..., :3]
    return rgb, _color_matrix1(tags)


def _normalize_levels(data: torch.Tensor, tags: Dict[int, list],
                      bits: int) -> torch.Tensor:
    """Black-subtract + white-normalize on data's device, honoring
    per-CFA-plane black levels (BlackLevelRepeatDim, common on real
    cameras).  Floating-point samples (SampleFormat=3) default to the
    [0, 1] range the DNG spec assigns them instead of the integer
    2^bits-1 full scale.  The levels and the scale are host scalars,
    computed in numpy as the JAX package computes them."""
    is_fp = tags.get(T_SAMPLE_FORMAT, [1])[0] == 3
    black = tags.get(T_BLACK_LEVEL, [0.0])
    white = tags.get(T_WHITE_LEVEL,
                     [1.0 if is_fp else float(2 ** bits - 1)])
    if len(set(float(v) for v in white)) > 1:
        raise RawError("per-sample DNG WhiteLevel values are not supported")
    white0 = f32(white[0])
    floor = f32(1e-9) if is_fp else f32(1.0)

    if len(black) == 1:
        black_map: np.ndarray = np.full((1, 1), f32(black[0]), np.float32)
    else:
        rep = tags.get(T_BLACK_REPEAT, [0, 0])
        rh, rw = (int(rep[0]), int(rep[1])) if len(rep) >= 2 else (0, 0)
        if rh * rw == len(black) and rh > 0:
            black_map = np.array(black, np.float32).reshape(rh, rw)
        elif data.dim() == 3 and len(black) == data.shape[2]:
            # per-sample black for linear multi-channel raws; scale by the
            # LARGEST black level (like the patterned branch below) so a
            # sensor-saturated pixel reaches 1.0 in every channel — the
            # white-preserving convention; excess in low-black channels
            # clips
            sub = data - torch.from_numpy(np.array(black, np.float32)).to(data.device)
            scale = f32(1.0) / np.maximum(white0 - f32(max(black)), floor)
            return torch.clamp(sub * float(scale), 0.0, 1.0)
        else:
            raise RawError(
                f"DNG BlackLevel with {len(black)} values needs a matching "
                "BlackLevelRepeatDim")
        if data.dim() != 2:
            raise RawError("patterned BlackLevel on a non-mosaic image")
    h, w = data.shape[:2]
    tiledb = _tile_map(black_map, h, w, data.device)
    if data.dim() == 3:
        tiledb = tiledb[..., None]
    scale = f32(1.0) / np.maximum(white0 - f32(black_map.max()), floor)
    return torch.clamp((data - tiledb) * float(scale), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Canon CR2
# ---------------------------------------------------------------------------

def load_cr2(path, device="cuda") -> np.ndarray:
    """Decode a Canon CR2 into RGBA u8 [H, W, 4], developed on `device`.

    CR2 = TIFF container ("CR\\x02" at offset 8) whose raw IFD stores one
    lossless-JPEG stream (Compression=6) cut into Canon's vertical slices
    (tag 0xc640).  Active area + masked-border black level come from the
    MakerNote SensorInfo (0x00e0); as-shot WB is probed from ColorData
    (0x4001) at the known per-generation offsets.  CFA is RGGB at the
    active-area origin (the Canon norm).
    """
    return _guarded("CR2", _decode_cr2, path, device)


def _decode_cr2(blob: bytes, device, timer=None) -> np.ndarray:
    return _finish_raw(*_develop_cr2(blob, device, timer), timer)


def _develop_cr2(blob: bytes, device, timer=None):
    """_develop_dng's split for CR2 (no colour matrix)."""
    with _stage(timer, "decode"):
        if blob[:2] != b"II":
            raise RawError("CR2 must be a little-endian TIFF container")
        end = "<"
        (magic,) = struct.unpack(end + "H", blob[2:4])
        if magic != 42 or blob[8:10] != b"CR":
            raise RawError("not a CR2 (missing CR magic)")
        # chained IFDs (no SubIFD recursion needed: CR2 keeps all four in
        # the top-level chain, raw last)
        ifds = []
        (off,) = struct.unpack(end + "I", blob[4:8])
        seen = set()
        while off and off not in seen and off + 2 <= len(blob):
            seen.add(off)
            tags, off2 = _parse_ifd(blob, end, off)
            ifds.append(tags)
            off = off2
        raw_ifds = [t for t in ifds
                    if t.get(T_COMPRESSION, [0])[0] == 6 and T_STRIP_OFFSETS in t]
        if not raw_ifds:
            raise RawError("no lossless-JPEG raw IFD found in CR2")
        rtags = raw_ifds[-1]
        offs = rtags[T_STRIP_OFFSETS]
        cnts = rtags.get(T_STRIP_COUNTS, [len(blob) - offs[0]])
        dec, prec = ljpeg_decode_full(blob[offs[0]:offs[0] + cnts[0]])
        h, w = dec.shape

        slices = rtags.get(T_CR2_SLICES)
        if slices and len(slices) >= 3 and slices[0] > 0:
            n, wa, wb = int(slices[0]), int(slices[1]), int(slices[2])
            widths = [wa] * n + [wb]
            if sum(widths) != w or min(widths) <= 0:
                raise RawError("CR2 slice widths do not cover the sensor width")
            flat = dec.reshape(-1)
            out = np.empty((h, w), np.uint16)
            pos = 0
            x0 = 0
            for sw in widths:
                out[:, x0:x0 + sw] = flat[pos:pos + h * sw].reshape(h, sw)
                pos += h * sw
                x0 += sw
            dec = out

        mn = _canon_makernote(blob, end, ifds)
        data = dec.astype(np.float32)
        black = 0.0
        black_measured = False
        sensor = mn.get(0x00E0) if mn else None
        if sensor and len(sensor) >= 9:
            left, top = int(sensor[5]), int(sensor[6])
            right, bottom = int(sensor[7]), int(sensor[8])
            if 0 <= top < bottom < h and 0 <= left < right < w:
                if left >= 4:  # masked border = optically black reference
                    # numpy's f32 pairwise mean on the host, as in the JAX
                    # package: a device reduction sums in another order
                    black = float(np.mean(data[top:bottom + 1, :left - 2]))
                    black_measured = True
                data = data[top:bottom + 1, left:right + 1]
        if not black_measured:
            # Canon sensors carry a large un-subtracted black offset that
            # is normally measured from the masked border; without
            # SensorInfo it cannot be measured, and per-camera defaults
            # are unverifiable constants.  Decode proceeds with black=0
            # but warns.
            import sys

            print("warning: CR2 SensorInfo (MakerNote 0x00e0) missing; black "
                  "level unknown, decoding with black=0 (image may look "
                  "washed out)", file=sys.stderr)
    with _stage(timer, "upload"):
        samples = _upload(data, device)
    with _stage(timer, "develop"):
        white = float((1 << prec) - 1)  # authoritative SOF3 precision
        # a host-scalar divisor: ieee_div keeps the card's divide IEEE
        norm = torch.clamp(ieee_div(samples - float(f32(black)), max(white - black, 1.0)),
                           0.0, 1.0)

        gains = np.array([1.0, 1.0, 1.0], np.float32)
        wb = _canon_as_shot_wb(mn.get(0x4001)) if mn else None
        if wb is not None:
            gains = wb
        pattern = np.array([[0, 1], [1, 2]], np.int32)  # RGGB
        rgb = _demosaic_bilinear(_apply_gains(norm, gains, pattern), pattern)
    with _stage(timer, "download"):
        return _download(rgb), None


def _canon_makernote(blob, end, ifds) -> Dict[int, list]:
    """Canon MakerNote = a plain IFD with absolute file offsets, reached
    via IFD0 -> ExifIFD(34665) -> MakerNote(37500)."""
    for t in ifds:
        exif_off = t.get(T_EXIF_IFD, [0])[0]
        if not exif_off:
            continue
        mn_off = _entry_data_offset(blob, end, exif_off, T_MAKER_NOTE)
        if mn_off:
            try:
                tags, _ = _parse_ifd(blob, end, mn_off)
                return tags
            except (struct.error, IndexError):
                return {}
    return {}


def _entry_data_offset(blob, end, ifd_off, want_tag) -> int:
    """Byte offset of a tag's out-of-line value area (0 if absent)."""
    if ifd_off + 2 > len(blob):
        return 0
    (n_tags,) = struct.unpack(end + "H", blob[ifd_off:ifd_off + 2])
    for k in range(n_tags):
        base = ifd_off + 2 + k * 12
        if base + 12 > len(blob):
            return 0
        tag, typ, count = struct.unpack(end + "HHI", blob[base:base + 8])
        if tag == want_tag:
            size = _TYPE_SIZES.get(typ, 1) * count
            if size <= 4:
                return base + 8
            (off,) = struct.unpack(end + "I", blob[base + 8:base + 12])
            return off
    return 0


# ColorData (Canon 0x4001) generations keyed by the tag's element count —
# the exiftool/dcraw convention: the count identifies the record layout, and
# the layout fixes the short-offset of WB_RGGBLevelsAsShot.  Only
# generations whose layout is attested are listed; anything else falls back
# to unit gains rather than probing blindly (a wrong quadruple would decode
# without error but with a color cast).
_CANON_COLORDATA_WB_OFFSET = {
    582: 25,                                   # ColorData1 (20D/350D)
    653: 68,                                   # ColorData2 (1D Mk II/1DS Mk II)
    796: 63,                                   # ColorData3 (1D Mark II N)
    692: 63, 674: 63, 702: 63, 1227: 63,       # ColorData4 (40D..1D Mk IV)
    1250: 63, 1251: 63, 1337: 63, 1338: 63, 1346: 63,
    1273: 63, 1275: 63,                        # ColorData6 (600D/1200D)
    1312: 63, 1313: 63, 1316: 63, 1506: 63,    # ColorData7 (5DmkIII..)
    1560: 63, 1592: 63, 1353: 63, 1602: 63,    # ColorData8 (5DS/80D/1DXmkII)
}


def _canon_as_shot_wb(colordata) -> Optional[np.ndarray]:
    """As-shot RGGB levels from ColorData (0x4001 shorts), keyed on the
    tag's element count (the layout version identifier); green-normalized
    gains, or None (= unit gains) when the generation is unrecognized or
    the levels fail the plausibility guard."""
    if not colordata:
        return None
    off = _CANON_COLORDATA_WB_OFFSET.get(len(colordata))
    if off is None or off + 4 > len(colordata):
        return None
    r, g1, g2, b = (float(v) for v in colordata[off:off + 4])
    if not all(64 <= v <= 8192 for v in (r, g1, g2, b)):
        return None
    g = 0.5 * (g1 + g2)
    if g <= 0 or abs(g1 - g2) > 0.25 * g:
        return None
    if not (0.2 <= r / g <= 5.0 and 0.2 <= b / g <= 5.0):
        return None
    return np.array([r / g, 1.0, b / g], np.float32)


# ---------------------------------------------------------------------------
# Nikon NEF (packed uncompressed)
# ---------------------------------------------------------------------------

def load_nef(path, device="cuda") -> np.ndarray:
    """Decode a Nikon NEF into RGBA u8 [H, W, 4], developed on `device`.

    Supported: TIFF-container NEFs whose raw SubIFD is uncompressed —
    either plain 16-bit or Nikon's packed 12/14-bit strips (MSB-first
    continuous bitstream).  Nikon-compressed (34713) raws raise a clear
    error.  As-shot WB is read from the Nikon MakerNote ("Nikon\\0" header
    + embedded TIFF) tag 0x000c WB_RBLevels when present; unit gains
    otherwise.
    """
    return _guarded("NEF", _decode_nef, path, device)


def _decode_nef(blob: bytes, device, timer=None) -> np.ndarray:
    return _finish_raw(*_develop_nef(blob, device, timer), timer)


def _develop_nef(blob: bytes, device, timer=None):
    """_develop_dng's split for NEF (no colour matrix)."""
    with _stage(timer, "decode"):
        end, ifds = _all_ifds(blob)
        cands = [t for t in ifds if t.get(T_PHOTOMETRIC, [0])[0] == 32803]
        if not cands:
            raise RawError("no CFA raw IFD found in NEF")
        tags = max(cands, key=lambda t: t.get(T_WIDTH, [0])[0] * t.get(T_HEIGHT, [0])[0])
        w = tags[T_WIDTH][0]
        h = tags[T_HEIGHT][0]
        bits = tags.get(T_BITS, [12])[0]
        comp = tags.get(T_COMPRESSION, [1])[0]
        if comp == 34713:
            raise RawError("Nikon-compressed NEF (34713) is not supported yet "
                           "(packed uncompressed NEFs decode natively)")
        if comp != 1:
            raise RawError(f"NEF compression {comp} is not supported")
        offsets = tags.get(T_STRIP_OFFSETS)
        counts = tags.get(T_STRIP_COUNTS)
        if not offsets or not counts:
            raise RawError("NEF raw IFD has no strip offsets")
        payload = b"".join(blob[o:o + c] for o, c in zip(offsets, counts))
        if bits == 16:
            dt = np.dtype(("<" if end == "<" else ">") + "u2")
            data = np.frombuffer(payload, dt, count=w * h).astype(np.float32)
        elif bits in (12, 14):
            data = _unpack_bits_msb(payload, bits, w * h).astype(np.float32)
        else:
            raise RawError(f"{bits}-bit NEF samples are not supported")
        data = data.reshape(h, w)

        pat = tags.get(T_CFA_PATTERN, [1, 0, 2, 1])  # Nikon norm: GRBG
        dim = tags.get(T_CFA_DIM, [2, 2])
        if dim[0] != 2 or dim[1] != 2 or len(pat) < 4:
            raise RawError("only 2x2 CFA patterns are supported")
        pattern = np.array(pat[:4], np.int32).reshape(2, 2)
    with _stage(timer, "upload"):
        samples = _upload(data, device)
    with _stage(timer, "develop"):
        white = float((1 << bits) - 1)
        norm = torch.clamp(ieee_div(samples, white), 0.0, 1.0)

        gains = _nikon_as_shot_wb(blob, end, ifds)
        if gains is not None:
            norm = _apply_gains(norm, gains, pattern)
        rgb = _demosaic_bilinear(norm, pattern)
    with _stage(timer, "download"):
        return _download(rgb), None


def _nikon_as_shot_wb(blob, end, ifds) -> Optional[np.ndarray]:
    """Green-normalized (r, 1, b) gains from MakerNote 0x000c WB_RBLevels
    (order R, B, G1, G2; rationals), or None.  The Nikon MakerNote is a
    "Nikon\\0<ver>" header followed by an embedded TIFF whose offsets are
    relative to that embedded header."""
    for t in ifds:
        exif_off = t.get(T_EXIF_IFD, [0])[0]
        if not exif_off:
            continue
        mn_off = _entry_data_offset(blob, end, exif_off, T_MAKER_NOTE)
        if not mn_off or blob[mn_off:mn_off + 5] != b"Nikon":
            continue  # later IFDs may still carry the Nikon MakerNote
        try:
            _, mn_ifds = _all_ifds(blob[mn_off + 10:])
        except RawError:
            continue
        for mt in mn_ifds:
            wb = mt.get(0x000C)
            if wb and len(wb) >= 4:
                r, b, g1, g2 = (float(v) for v in wb[:4])
                g = 0.5 * (g1 + g2) if (g1 or g2) else 1.0
                if g <= 0 or r <= 0 or b <= 0:
                    return None
                return np.array([r / g, 1.0, b / g], np.float32)
        return None
    return None


def _unpack_bits_msb(payload: bytes, bits: int, count: int) -> np.ndarray:
    """Unpack an MSB-first continuous bitstream of `bits`-wide samples."""
    need_bytes = (count * bits + 7) // 8
    if len(payload) < need_bytes:
        raise RawError("NEF strip data shorter than the packed raster")
    if bits == 12:
        # 3 bytes -> 2 samples, fully vectorized; an odd sample count
        # legally packs into ceil(count*12/8) bytes, half a triple short —
        # pad the tail so the pair math stays uniform
        n_pairs = (count + 1) // 2
        if len(payload) < n_pairs * 3:
            payload = payload + b"\0" * (n_pairs * 3 - len(payload))
        buf = np.frombuffer(payload, np.uint8, count=n_pairs * 3)
        b0 = buf[0::3].astype(np.uint16)
        b1 = buf[1::3].astype(np.uint16)
        b2 = buf[2::3].astype(np.uint16)
        s0 = (b0 << 4) | (b1 >> 4)
        s1 = ((b1 & 0x0F) << 8) | b2
        out = np.empty(n_pairs * 2, np.uint16)
        out[0::2] = s0
        out[1::2] = s1
        return out[:count]
    if bits == 14:
        # 4 samples per 7 bytes, MSB-first — same vectorized byte-slicing
        # shifts as the 12-bit path (the old unpackbits + u32 bit-matrix
        # multiply materialized ~2.5 GB of transients for a 45 MP sensor)
        n_quads = (count + 3) // 4
        need = n_quads * 7
        if len(payload) < need:
            payload = payload + b"\0" * (need - len(payload))
        buf = np.frombuffer(payload, np.uint8, count=need)
        b = [buf[i::7].astype(np.uint16) for i in range(7)]
        out = np.empty(n_quads * 4, np.uint16)
        out[0::4] = (b[0] << 6) | (b[1] >> 2)
        out[1::4] = ((b[1] & 0x03) << 12) | (b[2] << 4) | (b[3] >> 4)
        out[2::4] = ((b[3] & 0x0F) << 10) | (b[4] << 2) | (b[5] >> 6)
        out[3::4] = ((b[5] & 0x3F) << 8) | b[6]
        return out[:count]
    # generic path (odd widths): bit matrix multiply
    nbytes = (count * bits + 7) // 8
    bits_arr = np.unpackbits(np.frombuffer(payload, np.uint8, count=nbytes))
    bits_arr = bits_arr[:count * bits].reshape(count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    return (bits_arr.astype(np.uint32) @ weights).astype(np.uint16)


# ---------------------------------------------------------------------------
# TIFF/EP CFA families: Sony ARW, Pentax PEF, Samsung SRW, Olympus ORF
# ---------------------------------------------------------------------------
#
# rawloader (the reference's decoder, src/io.rs:36-80) reads these through
# per-maker modules; the verifiable subset here is their shared TIFF/EP
# container shape: a CFA raw IFD (PhotometricInterpretation 32803) holding
# plain 16-bit or MSB-packed 12/14-bit strips (Compression=1), plus — for
# Sony's newer lossless mode — SOF3 lossless-JPEG segments (Compression=7),
# which reuse the same native decoder the DNG/CR2 paths fuzz against an
# independent encoder.  Proprietary entropy codings (Sony ARW2 curve 32767,
# Pentax huffman 65535, Olympus mid-strip compression) raise targeted
# errors: their tables cannot be validated here without real camera files.
#
# Black/white levels honor DNG-style BlackLevel/WhiteLevel tags when the
# file carries them and default to 0 / full-scale otherwise (real cameras
# bury levels in maker notes whose layouts are unverifiable here); as-shot
# WB likewise comes from AsShotNeutral when present.

_ORF_MAGICS = (42, 0x4F52, 0x5253)  # "RO" (most models) / "SR" variants


def _decode_tiffep_cfa(blob: bytes, family: str, device, timer=None,
                       magics: Tuple[int, ...] = (42,)) -> np.ndarray:
    return _finish_raw(*_develop_tiffep_cfa(blob, family, device, timer, magics), timer)


def _develop_tiffep_cfa(blob: bytes, family: str, device, timer=None,
                        magics: Tuple[int, ...] = (42,)):
    """_develop_dng's split for the TIFF/EP families."""
    with _stage(timer, "decode"):
        end, ifds = _all_ifds(blob, magics)
        cands = [t for t in ifds if t.get(T_PHOTOMETRIC, [0])[0] == 32803]
        if not cands:
            raise RawError(f"no CFA raw IFD found in {family.upper()}")
        tags = max(cands,
                   key=lambda t: t.get(T_WIDTH, [0])[0] * t.get(T_HEIGHT, [0])[0])
        w = tags[T_WIDTH][0]
        h = tags[T_HEIGHT][0]
        bits = tags.get(T_BITS, [16])[0]
        comp = tags.get(T_COMPRESSION, [1])[0]

        if comp == 32767:
            raise RawError("Sony ARW2 curve-compressed raws are not supported "
                           "(uncompressed and lossless-JPEG ARW decode natively)")
        if comp == 65535:
            raise RawError("Pentax-compressed PEF raws are not supported "
                           "(uncompressed PEF decodes natively)")
        if comp == 7:
            data = np.asarray(_read_ljpeg_samples(blob, tags, w, h, 1,
                                                  T_TILE_OFFSETS in tags))
        elif comp != 1:
            raise RawError(f"{family.upper()} compression {comp} is not supported")
        else:
            offsets = tags.get(T_STRIP_OFFSETS)
            counts = tags.get(T_STRIP_COUNTS)
            if not offsets or not counts:
                raise RawError(f"{family.upper()} raw IFD has no strip offsets")
            payload = b"".join(blob[o:o + c] for o, c in zip(offsets, counts))
            if bits == 16:
                dt = np.dtype(("<" if end == "<" else ">") + "u2")
                if len(payload) < w * h * 2:
                    raise RawError(
                        f"{family.upper()} strip data shorter than the raster "
                        "(maker-compressed variant?)")
                data = np.frombuffer(payload, dt, count=w * h).astype(np.float32)
            elif bits in (12, 14):
                try:
                    data = _unpack_bits_msb(payload, bits, w * h).astype(np.float32)
                except RawError:
                    raise RawError(
                        f"{family.upper()} strip data shorter than the packed "
                        "raster (maker-compressed variant?)")
            else:
                raise RawError(
                    f"{bits}-bit {family.upper()} samples are not supported")
        data = np.asarray(data, np.float32).reshape(h, w)

        pat = tags.get(T_CFA_PATTERN, [0, 1, 1, 2])  # TIFF/EP default: RGGB
        dim = tags.get(T_CFA_DIM, [2, 2])
        if dim[0] != 2 or dim[1] != 2 or len(pat) < 4:
            raise RawError("only 2x2 CFA patterns are supported")
        pattern = np.array(pat[:4], np.int32).reshape(2, 2)
    with _stage(timer, "upload"):
        samples = _upload(data, device)
    with _stage(timer, "develop"):
        norm = _normalize_levels(samples, tags, bits)

        neutral = tags.get(T_AS_SHOT_NEUTRAL)
        if neutral and len(neutral) >= 3 and all(float(n) > 0 for n in neutral[:3]):
            wb = np.array([1.0 / float(n) for n in neutral[:3]], np.float32)
            wb = wb / max(wb[1], 1e-6)
            norm = _apply_gains(norm, wb, pattern)
        rgb = _demosaic_bilinear(norm, pattern)
    with _stage(timer, "download"):
        return _download(rgb), _color_matrix1(tags)


def _make_tiffep_loader(family: str, magics: Tuple[int, ...] = (42,)):
    def load(path, device="cuda") -> np.ndarray:
        return _guarded(family.upper(),
                        lambda blob, dev: _decode_tiffep_cfa(blob, family, dev, magics=magics),
                        path, device)
    load.__name__ = f"load_{family}"
    load.__doc__ = (
        f"Decode a {family.upper()} (TIFF/EP CFA container) into RGBA u8 "
        "[H, W, 4], developed on `device`; see the family notes above for "
        "the supported subset.")
    return load


load_arw = _make_tiffep_loader("arw")
load_pef = _make_tiffep_loader("pef")
load_srw = _make_tiffep_loader("srw")
load_orf = _make_tiffep_loader("orf", _ORF_MAGICS)


# ---------------------------------------------------------------------------
# Panasonic RW2 (and Leica RWL, the same container)
# ---------------------------------------------------------------------------

# PanasonicRaw tag ids (public exiftool table; dcraw's parser agrees)
P_SENSOR_WIDTH = 0x0002
P_SENSOR_HEIGHT = 0x0003
P_TOP_BORDER = 0x0004
P_LEFT_BORDER = 0x0005
P_BOTTOM_BORDER = 0x0006
P_RIGHT_BORDER = 0x0007
P_CFA_PATTERN = 0x0009
P_BITS = 0x000A
P_COMPRESSION = 0x000B
P_RED_BALANCE = 0x0011
P_BLUE_BALANCE = 0x0012
P_BLACK_RED = 0x001C
P_BLACK_GREEN = 0x001D
P_BLACK_BLUE = 0x001E
P_RAW_FORMAT = 0x002D
P_STRIP_OFFSETS = 0x0118

# CFAPattern enum -> 2x2 pattern of (0=R, 1=G, 2=B), row-major
_RW2_CFA = {1: [0, 1, 1, 2], 2: [1, 0, 2, 1], 3: [1, 2, 0, 1],
            4: [2, 1, 1, 0]}


def load_rw2(path, device="cuda") -> np.ndarray:
    """Decode a Panasonic RW2 / Leica RWL into RGBA u8 [H, W, 4],
    developed on `device`.

    RW2 is a TIFF container with magic 85 instead of 42 and Panasonic's
    own IFD0 tag set: sensor dims + active-area borders (0x0002-0x0007),
    a CFA-pattern ENUM (0x0009 — never the TIFF/EP pattern array), bit
    depth 0x000A, per-color black levels 0x001C-0x001E, WB as red/blue
    balances scaled by 256 (0x0011/0x0012), and raw data at 0x0118.
    Supported: the unpacked little-endian 16-bit sample layout; the
    sync-coded Panasonic bitstream (RawFormat >= 4's packed variants)
    raises a targeted error."""
    return _guarded("RW2", _decode_rw2, path, device)


def _decode_rw2(blob: bytes, device, timer=None) -> np.ndarray:
    return _finish_raw(*_develop_rw2(blob, device, timer), timer)


def _develop_rw2(blob: bytes, device, timer=None):
    """_develop_dng's split for RW2 (no colour matrix)."""
    with _stage(timer, "decode"):
        end, ifds = _all_ifds(blob, magics=(85,))
        tags = next((t for t in ifds if P_SENSOR_WIDTH in t
                     and P_SENSOR_HEIGHT in t), None)
        if tags is None:
            raise RawError("no Panasonic sensor IFD found in RW2")
        w = int(tags[P_SENSOR_WIDTH][0])
        h = int(tags[P_SENSOR_HEIGHT][0])
        bits = int(tags.get(P_BITS, [12])[0])
        offsets = tags.get(P_STRIP_OFFSETS) or tags.get(T_STRIP_OFFSETS)
        if not offsets:
            raise RawError("RW2 has no raw data offset")
        payload = blob[int(offsets[0]):]
        if len(payload) < w * h * 2:
            raise RawError("RW2 raw data shorter than an unpacked raster "
                           "(Panasonic sync-coded bitstreams are not supported)")
        data = np.frombuffer(payload, "<u2", count=w * h).astype(
            np.float32).reshape(h, w)

        cfa = int(tags.get(P_CFA_PATTERN, [1])[0])
        if cfa not in _RW2_CFA:
            raise RawError(f"RW2 CFA pattern enum {cfa} is not supported")
        pattern = np.array(_RW2_CFA[cfa], np.int32).reshape(2, 2)

        # active-area crop; the CFA enum describes the sensor origin, so
        # crop parity must carry into the pattern phase
        top = int(tags.get(P_TOP_BORDER, [0])[0])
        left = int(tags.get(P_LEFT_BORDER, [0])[0])
        bottom = int(tags.get(P_BOTTOM_BORDER, [h])[0]) or h
        right = int(tags.get(P_RIGHT_BORDER, [w])[0]) or w
        if not (0 <= top < bottom <= h and 0 <= left < right <= w):
            raise RawError("RW2 sensor borders outside image bounds")
        data = data[top:bottom, left:right]
        pattern = np.roll(np.roll(pattern, -top % 2, 0), -left % 2, 1)

        black = np.array([float(tags.get(P_BLACK_RED, [0])[0]),
                          float(tags.get(P_BLACK_GREEN, [0])[0]),
                          float(tags.get(P_BLACK_BLUE, [0])[0])], np.float32)
        white = float((1 << bits) - 1)
    with _stage(timer, "upload"):
        samples = _upload(data, device)
    with _stage(timer, "develop"):
        hh, ww = data.shape
        black_map = _site_gains(black, pattern, hh, ww, samples.device)
        norm = torch.clamp(ieee_div(samples - black_map, max(white - black.max(), 1.0)),
                           0.0, 1.0)

        red_bal = float(tags.get(P_RED_BALANCE, [256])[0]) / 256.0
        blue_bal = float(tags.get(P_BLUE_BALANCE, [256])[0]) / 256.0
        if red_bal > 0 and blue_bal > 0:
            wb = np.array([red_bal, 1.0, blue_bal], np.float32)
            norm = _apply_gains(norm, wb, pattern)
        rgb = _demosaic_bilinear(norm, pattern)
    with _stage(timer, "download"):
        return _download(rgb), None


def _apply_color_matrix(rgb: np.ndarray, cm_xyz_to_cam: np.ndarray) -> np.ndarray:
    """Camera RGB -> linear sRGB via ColorMatrix1 (XYZ->camera), using the
    standard normalized-inverse recipe: rgb_cam = inv(CM . M_srgb->xyz)
    with rows scaled so white maps to white."""
    m_srgb_to_xyz = np.array(
        [[0.4124564, 0.3575761, 0.1804375],
         [0.2126729, 0.7151522, 0.0721750],
         [0.0193339, 0.1191920, 0.9503041]], np.float32)
    cam_from_srgb = cm_xyz_to_cam @ m_srgb_to_xyz
    rows = cam_from_srgb.sum(axis=1, keepdims=True)
    if np.any(np.abs(rows) < 1e-8):
        return rgb  # degenerate matrix: skip color transform
    cam_from_srgb = cam_from_srgb / rows  # white-preserving normalization
    try:
        srgb_from_cam = np.linalg.inv(cam_from_srgb).astype(np.float32)
    except np.linalg.LinAlgError:
        return rgb
    return np.clip(rgb @ srgb_from_cam.T, 0.0, 1.0)


def _color_matrix1(tags) -> Optional[np.ndarray]:
    cm = tags.get(T_COLOR_MATRIX1)
    return np.array(cm, np.float32).reshape(3, 3) if cm and len(cm) == 9 else None


def _finish_raw(rgb: np.ndarray, cm: Optional[np.ndarray], timer=None) -> np.ndarray:
    """The host steps after the develop stage: the camera matrix where the
    file has one, then the sRGB encode and the u8 step."""
    if cm is not None:
        with _stage(timer, "matrix"):
            rgb = _apply_color_matrix(rgb, cm)
    return _finish_srgb(rgb, timer)


def _finish_srgb(rgb: np.ndarray, timer=None) -> np.ndarray:
    with _stage(timer, "srgb"):
        encoded = _srgb_encode(rgb)
    with _stage(timer, "u8"):
        out8 = np.clip(np.floor(encoded * f32(255.0) + f32(0.5)),
                       0, 255).astype(np.uint8)
        h, w = out8.shape[:2]
        rgba = np.empty((h, w, 4), np.uint8)
        rgba[..., :3] = out8
        rgba[..., 3] = 255
    return rgba
