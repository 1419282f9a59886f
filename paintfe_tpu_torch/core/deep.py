"""Deep pixel formats (U8/U16/F16/F32), HDR metadata and tonemapping,
adjustment-layer data (paintfe_tpu.core.deep counterpart).

Behavioral contract: src/experimental.rs (DeepRgbaBuffer conversions:
u16 = v*257, back = (x+128)//257; truncating f32->f16 bit converter;
Reinhard tonemap) and src/canvas/layers.rs:193-365 (PixelFormat,
HdrMetadata, ImageMetadata, AdjustmentKind + per-pixel application).

Everything here is host numpy except `AdjustmentLayerData.apply` and
`apply_with_opacity`, which run on torch tensors of any device (the
flatten keeps its accumulator on the card between raster runs), and
`DeepRgbaBuffer.sync_region_from_u8`, which converts a tensor's dirty
region where the tensor lies (a stroke's commit on the card).  Their
scalars (the exposure gain, the brightness/contrast factor) are computed on
the host in numpy f32, as the JAX package computes them, and never by a
card `pow` or divide.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from paintfe_tpu_torch.utils.quant import ieee_div

f32 = np.float32


class PixelFormat(enum.Enum):
    RGBA_U8 = "RgbaU8"
    RGBA_U16 = "RgbaU16"
    RGBA_F16 = "RgbaF16"
    RGBA_F32 = "RgbaF32"


def f32_to_f16_bits(values: np.ndarray) -> np.ndarray:
    """Truncating (not rounding) f32->f16 conversion — bit-parity with the
    reference's hand-rolled converter (experimental.rs:72-90)."""
    v = np.asarray(values, f32)
    bits = v.view(np.uint32)
    sign = ((bits >> 16) & 0x8000).astype(np.uint16)
    exp = ((bits >> 23) & 0xFF).astype(np.int32) - 127 + 15
    mant = bits & 0x7FFFFF

    # normal range
    normal = (sign | ((np.clip(exp, 0, 31).astype(np.uint32) << 10) & 0x7C00).astype(np.uint16)
              | (mant >> 13).astype(np.uint16))
    # subnormal
    mant_sub = mant | 0x800000
    shift = np.clip(14 - exp, 0, 31)
    subnormal = sign | (mant_sub >> shift).astype(np.uint16)
    out = np.where(exp >= 31, sign | 0x7C00,
                   np.where(exp <= 0, np.where(exp < -10, sign, subnormal), normal))
    return out.astype(np.uint16)


def f16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Exact f16->f32 (numpy's IEEE conversion is exact)."""
    return np.asarray(bits, np.uint16).view(np.float16).astype(f32)


@dataclasses.dataclass
class DeepRgbaBuffer:
    """High-bit-depth layer payload; `data` is flat, 4 values per pixel."""

    format: PixelFormat
    data: np.ndarray

    @classmethod
    def from_rgba8(cls, img: np.ndarray, fmt: PixelFormat) -> "DeepRgbaBuffer":
        flat = np.asarray(img, np.uint8).reshape(-1)
        fmt = PixelFormat(fmt)
        if fmt == PixelFormat.RGBA_U8:
            return cls(fmt, flat.copy())
        if fmt == PixelFormat.RGBA_U16:
            return cls(fmt, flat.astype(np.uint16) * 257)
        if fmt == PixelFormat.RGBA_F16:
            return cls(fmt, f32_to_f16_bits(flat.astype(f32) / f32(255.0)))
        return cls(fmt, flat.astype(f32) / f32(255.0))

    def to_rgba8(self, width: int, height: int) -> np.ndarray:
        fmt = PixelFormat(self.format)
        if fmt == PixelFormat.RGBA_U8:
            out = self.data.astype(np.uint8)
        elif fmt == PixelFormat.RGBA_U16:
            out = ((self.data.astype(np.uint32) + 128) // 257).astype(np.uint8)
        elif fmt == PixelFormat.RGBA_F16:
            v = np.clip(f16_bits_to_f32(self.data), 0.0, 1.0) * f32(255.0)
            out = np.floor(v + f32(0.5)).astype(np.uint8)
        else:
            v = np.clip(self.data.astype(f32), 0.0, 1.0) * f32(255.0)
            out = np.floor(v + f32(0.5)).astype(np.uint8)
        return out.reshape(height, width, 4)

    def sync_region_from_u8(self, preview, x0: int, y0: int, x1: int, y1: int):
        """Update only the dirty region [y0:y1, x0:x1] from the u8 preview
        (layers.rs:506-583): untouched deep samples keep full precision.

        `preview` is the whole u8 [H, W, 4] layer, a numpy array or a torch
        tensor on any device; a tensor's region converts where it lies
        (the f32 quotient by 255 a true divide) and is read back once, the
        f16 bit conversion on the host.  The origin is clamped as well as
        the far corner, so a dab straddling the top or left edge syncs."""
        h, w = preview.shape[:2]
        x0 = max(x0, 0)
        y0 = max(y0, 0)
        x1 = min(x1, w)
        y1 = min(y1, h)
        if x0 >= x1 or y0 >= y1:
            return
        region = preview[y0:y1, x0:x1]
        fmt = PixelFormat(self.format)
        flat = self.data.reshape(h, w, 4)
        if isinstance(region, torch.Tensor):
            if fmt == PixelFormat.RGBA_U8:
                flat[y0:y1, x0:x1] = region.cpu().numpy()
            elif fmt == PixelFormat.RGBA_U16:
                flat[y0:y1, x0:x1] = (region.to(torch.int32) * 257).cpu().numpy()
            else:
                unit = ieee_div(region.float(), 255.0).cpu().numpy()
                flat[y0:y1, x0:x1] = (unit if fmt == PixelFormat.RGBA_F32
                                      else f32_to_f16_bits(unit).reshape(unit.shape))
        elif fmt == PixelFormat.RGBA_U8:
            flat[y0:y1, x0:x1] = region
        elif fmt == PixelFormat.RGBA_U16:
            flat[y0:y1, x0:x1] = region.astype(np.uint16) * 257
        elif fmt == PixelFormat.RGBA_F16:
            flat[y0:y1, x0:x1] = f32_to_f16_bits(
                region.astype(f32) / f32(255.0)).reshape(region.shape)
        else:
            flat[y0:y1, x0:x1] = region.astype(f32) / f32(255.0)
        self.data = flat.reshape(-1)


@dataclasses.dataclass
class HdrMetadata:
    enabled: bool = False
    max_luminance_nits: Optional[float] = None
    reference_white_nits: Optional[float] = None
    transfer_function: Optional[str] = None


@dataclasses.dataclass
class ImageMetadata:
    source_format: Optional[str] = None
    source_name: Optional[str] = None
    color_profile_name: Optional[str] = None
    png_text_chunks: List[Tuple[str, str]] = dataclasses.field(default_factory=list)


def reinhard_tone_map(pixel, exposure: float):
    """x*e / (1 + x*e) per RGB channel; alpha passes through
    (experimental.rs:59-70)."""
    p = np.asarray(pixel, f32)
    e = f32(max(exposure, 0.0))
    x = np.maximum(p[..., 0:3] * e, 0.0)
    rgb = np.floor(x / (f32(1.0) + x) * f32(255.0) + f32(0.5))
    a = np.floor(np.clip(p[..., 3:4], 0.0, 1.0) * f32(255.0) + f32(0.5))
    return np.clip(np.concatenate([rgb, a], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Adjustment layers
# ---------------------------------------------------------------------------


class AdjustmentKind(enum.IntEnum):
    EXPOSURE = 0
    BRIGHTNESS_CONTRAST = 1
    INVERT = 2
    CHANNEL_MIXER = 3


def _bc_factor(contrast) -> np.float32:
    c = f32(contrast)
    return (f32(259.0) * (c + f32(255.0))) / (f32(255.0) * (f32(259.0) - c))


@dataclasses.dataclass
class AdjustmentLayerData:
    kind: AdjustmentKind = AdjustmentKind.EXPOSURE
    ev: float = 0.0
    brightness: float = 0.0
    contrast: float = 0.0
    red: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    green: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 0.0)
    blue: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 0.0)
    alpha: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)

    def apply(self, pixels: torch.Tensor) -> torch.Tensor:
        """Vectorized apply_to_pixel (layers.rs:276-313) of u8 [..., 4] on
        the tensor's device: f32 math, one op at a time, truncating cast."""
        p = pixels.float()
        r, g, b, a = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
        if self.kind == AdjustmentKind.EXPOSURE:
            gain = float(f32(2.0) ** f32(self.ev))
            out = torch.stack([torch.clamp(r * gain, 0, 255), torch.clamp(g * gain, 0, 255),
                               torch.clamp(b * gain, 0, 255), a], dim=-1)
        elif self.kind == AdjustmentKind.BRIGHTNESS_CONTRAST:
            factor = float(_bc_factor(self.contrast))
            brightness = float(f32(self.brightness))

            def ap(v):
                return torch.clamp((v + brightness - 128.0) * factor + 128.0, 0, 255)
            out = torch.stack([ap(r), ap(g), ap(b), a], dim=-1)
        elif self.kind == AdjustmentKind.INVERT:
            out = torch.stack([255.0 - r, 255.0 - g, 255.0 - b, a], dim=-1)
        else:
            def mix(m):
                m = [float(v) for v in np.asarray(m, f32)]
                return torch.clamp(r * m[0] + g * m[1] + b * m[2] + a * m[3], 0, 255)
            out = torch.stack([mix(self.red), mix(self.green), mix(self.blue),
                               mix(self.alpha)], dim=-1)
        return out.to(torch.uint8)  # truncating cast, like Rust `as u8`

    def apply_to_f32_with_opacity(self, pixels: np.ndarray, opacity: float) -> np.ndarray:
        """Vectorized apply_to_f32_with_opacity (layers.rs:327-362) on the
        host: operates in the 0..1 domain, clamps only below (HDR values
        pass through)."""
        p = pixels.astype(f32)
        r, g, b, a = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
        if self.kind == AdjustmentKind.EXPOSURE:
            gain = f32(2.0) ** f32(self.ev)
            adj = np.stack([r * gain, g * gain, b * gain, a], axis=-1)
        elif self.kind == AdjustmentKind.BRIGHTNESS_CONTRAST:
            factor = _bc_factor(self.contrast)
            brt = f32(self.brightness) / f32(255.0)

            def ap(v):
                return np.maximum(factor * (v + brt - f32(0.5)) + f32(0.5), f32(0.0))
            adj = np.stack([ap(r), ap(g), ap(b), a], axis=-1)
        elif self.kind == AdjustmentKind.INVERT:
            adj = np.stack([1.0 - r, 1.0 - g, 1.0 - b, a], axis=-1)
        else:
            def mix(m):
                m = np.asarray(m, f32)
                return np.maximum(r * m[0] + g * m[1] + b * m[2] + a * m[3], f32(0.0))
            adj = np.stack([mix(self.red), mix(self.green), mix(self.blue),
                            mix(self.alpha)], axis=-1)
        t = f32(np.clip(opacity, 0.0, 1.0))
        return (p * (f32(1.0) - t) + adj * t).astype(f32)

    def apply_with_opacity(self, pixels: torch.Tensor, opacity: float) -> torch.Tensor:
        """The adjustment lerped with the input by the clipped opacity, then
        rounded half up to u8, on the tensor's device."""
        adjusted = self.apply(pixels).float()
        t = f32(np.clip(opacity, 0.0, 1.0))
        inv = float(f32(1.0) - t)
        out = pixels.float() * inv + adjusted * float(t)
        return torch.floor(out + 0.5).to(torch.uint8)  # .round() as u8
