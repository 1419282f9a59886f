"""Image codecs (host-side, PIL-backed): the port's own copy of
paintfe_tpu.io.codecs, byte for byte the same encoders.

Behavioral contract: src/io.rs — read PNG/JPEG/WebP/BMP/TIFF/TGA/GIF/APNG/ICO
(io.rs:36-80, 693-1100), write PNG/JPEG/WebP(lossless default)/BMP/TGA/ICO/
TIFF/GIF/APNG (encode_and_write io.rs:1723+), animated decode/encode with
"each visible layer = one frame" semantics and fps -> centisecond GIF delay
max(round(100/fps), 1) (io.rs:2774-2885).  RAW camera files (DNG, CR2, NEF/NRW, ARW, PEF, SRW,
ORF, RW2/RWL) decode through io/raw.py, which develops them on the torch
device passed to load_image; the other RAW extensions raise a clear error.
GIF palettes come from the port's NeuQuant (io/neuquant.py).
"""

from __future__ import annotations

import pathlib
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

# the reference's full recognized-RAW list (io.rs RAW_EXTENSIONS)
RAW_EXTS = {
    "cr2", "cr3", "nef", "nrw", "arw", "srf", "sr2", "dng", "orf", "rw2",
    "pef", "raf", "raw", "rwl", "srw", "x3f", "3fr", "fff", "iiq", "mrw",
    "mef", "mos", "kdc", "dcr", "erf",
}

class CodecError(Exception):
    pass


def format_extension(fmt: str) -> str:
    return {"jpeg": "jpg"}.get(fmt, fmt)


def load_image(path, device="cuda") -> np.ndarray:
    """Load any supported raster file as RGBA u8 [H, W, 4].  A RAW camera
    file is developed on `device` (the card unless the caller asks for the
    CPU); no other format touches it."""
    ext = pathlib.Path(path).suffix.lower().lstrip(".")
    if ext in ("dng", "cr2", "nef", "nrw", "arw", "pef", "srw", "orf",
               "rw2", "rwl"):
        from paintfe_tpu_torch.io import raw

        # .nrw is Nikon's NEF variant and .rwl Leica's RW2 variant, each
        # sharing the donor format's TIFF layout
        loader = {"dng": raw.load_dng, "cr2": raw.load_cr2,
                  "nef": raw.load_nef, "nrw": raw.load_nef,
                  "arw": raw.load_arw, "pef": raw.load_pef,
                  "srw": raw.load_srw, "orf": raw.load_orf,
                  "rw2": raw.load_rw2, "rwl": raw.load_rw2}[ext]
        try:
            return loader(path, device=device)
        except raw.RawError as e:
            raise CodecError(f"failed to decode {ext.upper()} '{path}': {e}")
    if ext in RAW_EXTS:
        raise CodecError(
            f"RAW camera format '.{ext}' requires a raw decoder not present "
            "in this environment (DNG/CR2/NEF/ARW/PEF/SRW/ORF/RW2 decode "
            "natively)"
        )
    try:
        img = Image.open(path)
        img.load()
    except Exception as e:
        raise CodecError(f"failed to decode '{path}': {e}")
    return np.asarray(img.convert("RGBA"), np.uint8)


def load_frames(path) -> Tuple[List[np.ndarray], List[int]]:
    """Decode an animated GIF/APNG/WebP into (frames, per-frame ms delays).

    Delays clamp below at 10 ms like the reference's MIN_FRAME_DELAY_MS
    (io.rs:2293, :2380 — zero/missing GCE delays are extremely common in
    real GIFs); decode failures surface as CodecError like load_image."""
    try:
        img = Image.open(path)
        frames = []
        delays = []
        try:
            n = getattr(img, "n_frames", 1)
        except Exception:
            n = 1
        for i in range(n):
            img.seek(i)
            frames.append(np.asarray(img.convert("RGBA"), np.uint8))
            delays.append(max(int(img.info.get("duration", 0)), 10))
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"failed to decode animation '{path}': {e}")
    return frames, delays


def detect_animation(path) -> bool:
    try:
        img = Image.open(path)
        return getattr(img, "n_frames", 1) > 1
    except Exception:
        return False


def save_image(img: np.ndarray, path, fmt: Optional[str] = None, quality: int = 90,
               webp_lossless: bool = True, tiff_compression: str = "none"):
    """Encode one RGBA image (encode_and_write parity for the common knobs)."""
    img = np.asarray(img, np.uint8)
    path = str(path)
    if fmt is None:
        fmt = pathlib.Path(path).suffix.lower().lstrip(".") or "png"
        fmt = {"jpg": "jpeg", "tif": "tiff"}.get(fmt, fmt)
    pil = Image.fromarray(img, "RGBA")
    try:
        if fmt == "png":
            pil.save(path, format="PNG")
        elif fmt == "jpeg":
            pil.convert("RGB").save(path, format="JPEG", quality=int(quality))
        elif fmt == "webp":
            if webp_lossless:
                pil.save(path, format="WEBP", lossless=True)
            else:
                pil.save(path, format="WEBP", quality=int(quality))
        elif fmt == "bmp":
            # the reference encodes Rgba8 BMPs (alpha preserved); PIL's
            # writer drops alpha, so write the 32bpp V4 header ourselves
            _write_bmp_rgba(img, path)
        elif fmt == "tga":
            pil.save(path, format="TGA")
        elif fmt == "ico":
            # exact-size entry like the reference (Lanczos-capped only at
            # 256); PIL defaults would downscale to its sizes list
            h_, w_ = img.shape[:2]
            pil.save(path, format="ICO",
                     sizes=[(min(w_, 256), min(h_, 256))])
        elif fmt == "tiff":
            comp = {"none": None, "lzw": "tiff_lzw", "deflate": "tiff_deflate"}.get(
                tiff_compression.lower()
            )
            if comp:
                pil.save(path, format="TIFF", compression=comp)
            else:
                pil.save(path, format="TIFF")
        elif fmt == "gif":
            # No transparent index on purpose: the reference's GIF path
            # (quantize_rgba io.rs:2960-2989 + gif::Frame default) builds an
            # RGB-only palette with no transparency either — transparent
            # pixels flatten to their stored RGB in both implementations.
            # Palette = NeuQuant like encode_static_gif (io.rs:2743-2767).
            _gif_p_frame(np.asarray(pil.convert("RGBA"), np.uint8),
                         256).save(path, format="GIF")
        else:
            raise CodecError(f"unsupported save format '{fmt}'")
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"failed to encode '{path}': {e}")


def _gif_p_frame(rgba: np.ndarray, colors: int) -> "Image.Image":
    """RGBA u8 [H, W, 4] -> PIL 'P' image carrying a NeuQuant palette —
    the reference's quantize_rgba (io.rs:2960-2989, color_quant NeuQuant
    at samplefac 10 over RGBA)."""
    from paintfe_tpu_torch.io.neuquant import quantize_rgba

    h, w = rgba.shape[0], rgba.shape[1]
    palette, indices = quantize_rgba(rgba, colors)
    pim = Image.fromarray(indices.reshape(h, w), "P")
    pim.putpalette(palette.reshape(-1).tobytes())
    return pim


def gif_delay_cs(fps: float) -> int:
    """fps -> GIF centisecond delay: max(round(100/fps), 1), saturated to
    u16 like the reference's `as u16` cast (io.rs:2786-2789); PIL's writer
    rejects >65535."""
    return min(max(int(round(100.0 / max(fps, 0.001))), 1), 65535)


def apng_delay_ms(fps: float) -> int:
    """fps -> APNG ms delay: round(1000/fps) clamped to [1, 65535]
    (io.rs:2837-2839; the APNG fcTL num/den pair is delay_ms/1000)."""
    return int(np.clip(round(1000.0 / max(fps, 0.001)), 1, 65535))


def webp_delay_ms(fps: float) -> int:
    """fps -> WebP ms delay: fps floored at 1.0 before the divide
    (io.rs:2921 `fps.max(1.0)`), rounded, at least 1."""
    return max(int(round(1000.0 / max(fps, 1.0))), 1)


def save_animation(frames: List[np.ndarray], path, fmt: str = "gif",
                   fps: float = 10.0, quality: int = 90,
                   max_colors: int = 256, webp_lossless: bool = True):
    """Encode frames as animated GIF / APNG / WebP ("each visible layer = one
    frame", io.rs:2774-2940).  GIF: infinite repeat, per-frame adaptive
    palettes of `max_colors` clamped to 2..256 (io.rs:2794); all frames must
    share the first frame's dimensions."""
    if not frames:
        raise CodecError("no frames to encode")
    frames = [np.asarray(fr, np.uint8) for fr in frames]
    h, w = frames[0].shape[0], frames[0].shape[1]
    if any(fr.shape[0] != h or fr.shape[1] != w for fr in frames):
        raise CodecError("all animation frames must have the same dimensions")
    pils = [Image.fromarray(fr, "RGBA") for fr in frames]
    path = str(path)
    try:
        if fmt == "gif":
            if w > 65535 or h > 65535:
                raise CodecError(
                    "image dimensions exceed GIF maximum (65535x65535)")
            # PIL takes the duration in ms but bounds it at u16 (65535 ms
            # ~ 6553 cs) — clamp so very low fps encodes instead of
            # crashing; gif_delay_cs itself saturates at the SPEC's
            # 65535 cs for non-PIL consumers
            delay_ms = min(gif_delay_cs(fps) * 10, 65535)
            colors = int(np.clip(max_colors, 2, 256))
            # reference palette discipline (io.rs:2794-2812): NeuQuant
            # global palette from the first frame + a NeuQuant local
            # palette per frame; PIL writes the first frame's palette as
            # the global table and local tables where palettes differ
            base = [_gif_p_frame(fr, colors) for fr in frames]
            base[0].save(
                path, format="GIF", save_all=True, append_images=base[1:],
                duration=delay_ms, loop=0, disposal=2,
            )
        elif fmt in ("apng", "png"):
            delay_ms = apng_delay_ms(fps)
            pils[0].save(
                path, format="PNG", save_all=True, append_images=pils[1:],
                duration=delay_ms, loop=0, default_image=False,
            )
        elif fmt == "webp":
            delay_ms = webp_delay_ms(fps)
            if webp_lossless:
                # the reference's animated WebP defaults every frame to
                # LOSSLESS (encode_animated_webp frame_modes unwrap_or
                # Lossless) — quality-90 VP8 silently degraded pixels
                pils[0].save(
                    path, format="WEBP", save_all=True,
                    append_images=pils[1:], duration=delay_ms, loop=0,
                    lossless=True,
                )
            else:
                pils[0].save(
                    path, format="WEBP", save_all=True,
                    append_images=pils[1:], duration=delay_ms, loop=0,
                    quality=int(quality),
                )
        else:
            raise CodecError(f"unsupported animation format '{fmt}'")
    except CodecError:
        raise
    except Exception as e:
        # PIL/OS errors must surface as CodecError: the CLI's keep-going
        # handler catches only the module's documented error type
        raise CodecError(f"failed to encode animation '{path}': {e}")


def _write_bmp_rgba(img: np.ndarray, path: str):
    """32bpp BITMAPV4 BMP with alpha masks (the reference's BmpEncoder
    writes Rgba8; PIL's own BMP writer drops alpha)."""
    import struct

    h, w = img.shape[:2]
    rows = img[::-1][..., [2, 1, 0, 3]].tobytes()  # bottom-up BGRA
    dib = struct.pack("<IiiHHIIiiII", 108, w, h, 1, 32, 3, len(rows),
                      2835, 2835, 0, 0)
    dib += struct.pack("<IIII", 0x00FF0000, 0x0000FF00, 0x000000FF,
                       0xFF000000)
    dib += struct.pack("<I", 0x73524742)  # LCS 'sRGB'
    dib += b"\x00" * 36 + struct.pack("<III", 0, 0, 0)
    off = 14 + 108
    header = b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off)
    with open(path, "wb") as fh:
        fh.write(header + dib + rows)
