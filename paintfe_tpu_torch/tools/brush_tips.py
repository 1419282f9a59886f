"""Image brush tips: custom grayscale stamp masks (paintfe_tpu.tools.brush_tips
counterpart).

Behavioral contract: src/config/brushes.rs (`load_brush_tip` :1290-1388 —
PNG decoded to luma8, padded to a square canonical mask) and
src/ui/panels/tools/behavior/raster/brush_render.rs (`rebuild_tip_mask`
:402-530 — bilinear rescale to the brush size, hardness-as-contrast remap,
ratio-scaled box-blur AA passes on big downscales; `draw_image_tip_no_dirty`
:533-720 — scatter/rotation via `stamp_hash`, inverse-rotated bilinear mask
sampling, max-alpha stamping; jitter helpers :556-624, :846-856).

Where the work runs: `draw_image_tip` stamps into a u8 [H, W, 4] tensor on
its own device (the rotated tip is a plain gather whose lerps round to u8
each, like the JAX package's, not a bilinear warp).  The tip registry, the
rebuilt [D, D] mask (once a stroke), the stamp hash and the colour jitter
are host work on scalars and small arrays, as in the JAX package, and the
13 procedural stock tips are the same host numpy calls (their per-pixel
transcendentals stay host numpy, ROADMAP C2).
"""

from __future__ import annotations

import dataclasses
import io
from typing import Dict, List, Optional

import numpy as np
import torch

from paintfe_tpu_torch.tools.stamp import check_target, resident, selected
from paintfe_tpu_torch.utils.quant import ieee_div, round_half_away

f32 = np.float32
U32 = np.uint32


@dataclasses.dataclass
class BrushTipData:
    name: str
    category: str
    mask: np.ndarray  # u8 [S, S], square canonical
    mask_size: int

    @classmethod
    def from_jax(cls, tip) -> "BrushTipData":
        """The port's tip from the JAX package's (its fields read as plain
        values and a numpy array)."""
        return cls(str(tip.name), str(tip.category), np.array(tip.mask, np.uint8),
                   int(tip.mask_size))


class BrushTipLibrary:
    """Registry of loaded tip masks (the Assets subset the tool engine uses)."""

    def __init__(self):
        self.tips: Dict[str, BrushTipData] = {}
        self.categories: Dict[str, List[str]] = {}

    def load_brush_tip(self, name: str, category: str, png_data: bytes) -> BrushTipData:
        from PIL import Image

        gray = np.asarray(Image.open(io.BytesIO(png_data)).convert("L"), np.uint8)
        gh, gw = gray.shape
        canonical = max(gw, gh)
        mask = np.zeros((canonical, canonical), np.uint8)
        mask[:gh, :gw] = gray  # top-left pad to square (brushes.rs:1346-1358)
        tip = BrushTipData(name, category, mask, canonical)
        old = self.tips.get(name)
        if old is not None and old.category != category:
            # re-registering under a new category must not leave the name
            # dangling in the old category's listing
            if name in self.categories.get(old.category, []):
                self.categories[old.category].remove(name)
        self.tips[name] = tip
        self.categories.setdefault(category, [])
        if name not in self.categories[category]:
            self.categories[category].append(name)
        return tip

    def remove_brush_tip(self, name: str) -> bool:
        tip = self.tips.pop(name, None)
        if tip is None:
            return False
        if name in self.categories.get(tip.category, []):
            self.categories[tip.category].remove(name)
        return True

    def get(self, name: str) -> Optional[BrushTipData]:
        return self.tips.get(name)


def _round_half_away(x):
    return np.floor(np.abs(x) + 0.5) * np.sign(x)


def rebuild_tip_mask(tip: BrushTipData, size: float, hardness: float) -> np.ndarray:
    """Rescale the canonical mask to the brush size, apply hardness contrast
    and the downscale AA blur (brush_render.rs:402-530).  Returns u8 [D, D]
    on the host: it is built once a stroke, and each stamp gathers from its
    upload."""
    src = tip.mask.astype(f32)
    src_size = tip.mask_size
    dst_size = max(int(np.ceil(size)), 1)

    scale = f32(src_size) / f32(dst_size)
    d = np.arange(dst_size, dtype=f32)
    sx = d[None, :] * scale
    sy = d[:, None] * scale
    sx0 = np.floor(sx).astype(np.int64)
    sy0 = np.floor(sy).astype(np.int64)
    sx1 = np.minimum(sx0 + 1, src_size - 1)
    sy1 = np.minimum(sy0 + 1, src_size - 1)
    fx = (sx - sx0).astype(f32)
    fy = (sy - sy0).astype(f32)
    v00 = src[sy0, sx0]
    v10 = src[sy0, sx1]
    v01 = src[sy1, sx0]
    v11 = src[sy1, sx1]
    top = v00 * (1.0 - fx) + v10 * fx
    bot = v01 * (1.0 - fx) + v11 * fx
    val = top * (1.0 - fy) + bot * fy
    mask = np.minimum(_round_half_away(val), 255.0).astype(np.uint8)

    # hardness as contrast (threshold remap)
    h = float(hardness)
    if h < 0.99:
        threshold = (1.0 - h) * 0.6
        rng = 1.0 - threshold
        norm = mask.astype(f32) / f32(255.0)
        adj = np.clip((norm - f32(threshold)) / f32(rng), 0.0, 1.0)
        mask = _round_half_away(adj * 255.0).astype(np.uint8)

    # AA box-blur passes on significant downscale (integer truncating mean)
    if dst_size < src_size and dst_size >= 3:
        ratio = src_size / dst_size
        passes = 2 if ratio > 4.0 else (1 if ratio > 1.5 else 0)
        for _ in range(passes):
            m = mask.astype(np.uint32)
            for axis in (1, 0):  # horizontal then vertical
                left = np.roll(m, 1, axis=axis)
                right = np.roll(m, -1, axis=axis)
                count = np.full(m.shape, 3, np.uint32)
                if axis == 1:
                    left[:, 0] = 0
                    right[:, -1] = 0
                    count[:, 0] = 2
                    count[:, -1] = 2
                else:
                    left[0, :] = 0
                    right[-1, :] = 0
                    count[0, :] = 2
                    count[-1, :] = 2
                m = (m + left + right) // count
            mask = m.astype(np.uint8)
    return mask


def _sat_u32(v: float) -> int:
    """Rust `f32 as u32` is a SATURATING cast: negatives clamp to 0,
    overflow clamps to u32::MAX, NaN becomes 0 (off-canvas stamp centers
    make negative coordinates reachable here)."""
    f = float(np.trunc(np.float32(v)))
    if f != f:  # NaN
        return 0
    return int(min(max(f, 0.0), 4294967295.0))


def stamp_hash(x: float, y: float, counter: int) -> int:
    """brush_render.rs:846-856 — wrapping position hash for jitter/scatter."""
    with np.errstate(invalid="ignore", over="ignore"):  # wrapping on purpose
        ix = U32(_sat_u32(np.float32(x) * np.float32(100.0)))
        iy = U32(_sat_u32(np.float32(y) * np.float32(100.0)))
        h = (ix * U32(374761393) + iy * U32(668265263)
             + U32(counter & 0xFFFFFFFF) * U32(1013904223))
        h ^= h >> U32(13)
        h *= U32(1274126177)
        h ^= h >> U32(16)
    return int(h)


# `h as f32 / (u32::MAX as f32)`: u32::MAX rounds UP to 4294967296.0 in
# f32, and the hash itself rounds to f32 before the divide — both matter
# for bit-stable parity of scatter offsets and jitter amounts.
_U32_MAX_F32 = np.float32(4294967296.0)


def hash_unit(x: float, y: float, counter: int) -> np.float32:
    return np.float32(np.float32(stamp_hash(x, y, counter)) / _U32_MAX_F32)


def _lerp(a, b, t):
    """a * (1 - t) + b * t, one f32 operation at a time (never torch.lerp,
    which fuses on the card)."""
    return a * (1.0 - t) + b * t


def draw_image_tip(target: torch.Tensor, pos, mask, color,
                   *, is_eraser: bool = False, flow: float = 1.0,
                   rotation_deg: float = 0.0, scatter: float = 0.0,
                   stamp_counter: int = 0, brush_size: Optional[float] = None,
                   selection=None) -> None:
    """One image-tip stamp into `target` (u8 [H, W, 4] tensor, mutated in
    place on its device), max-alpha accumulation (brush_render.rs:533-720).

    `mask` is the rebuilt [D, D] u8 tip (a host array, or its upload a
    stroke keeps); `color` is (r, g, b, a) u8; `selection` a host array or
    a tensor."""
    check_target(target)
    dev = target.device
    h, w = target.shape[:2]
    mask_size = mask.shape[0]
    if mask_size == 0:
        return
    cx, cy = float(pos[0]), float(pos[1])
    if scatter > 0.01:
        diam = f32(brush_size if brush_size is not None else mask_size)
        h1 = hash_unit(cx, cy, stamp_counter)
        h2 = hash_unit(cy, cx, (stamp_counter + 99991) & 0xFFFFFFFF)
        # all-f32 offset math, like the reference (bit-stable parity)
        cx = float(f32(cx) + (h1 * f32(2.0) - f32(1.0)) * f32(scatter) * diam)
        cy = float(f32(cy) + (h2 * f32(2.0) - f32(1.0)) * f32(scatter) * diam)
    half = mask_size / 2.0

    rotated = abs(rotation_deg) > 0.01
    if rotated:
        rad = -np.radians(np.float32(rotation_deg))
        cos_a, sin_a = f32(np.cos(rad)), f32(np.sin(rad))
        eff_half = half * np.sqrt(2.0)
    else:
        cos_a, sin_a = f32(1.0), f32(0.0)
        eff_half = half

    min_x = int(max(cx - eff_half, 0.0))
    min_y = int(max(cy - eff_half, 0.0))
    max_x = min(int(cx + eff_half), w - 1)
    max_y = min(int(cy + eff_half), h - 1)
    if min_x > max_x or min_y > max_y:
        return

    m = resident(mask, dev).float()
    rel_x = (torch.arange(min_x, max_x + 1, device=dev, dtype=torch.float32)
             - float(f32(cx)))[None, :]
    rel_y = (torch.arange(min_y, max_y + 1, device=dev, dtype=torch.float32)
             - float(f32(cy)))[:, None]
    shape = (max_y - min_y + 1, max_x - min_x + 1)
    rel_x, rel_y = rel_x.expand(shape), rel_y.expand(shape)
    half32 = float(f32(half))

    if rotated:
        rot_x = rel_x * float(cos_a) - rel_y * float(sin_a) + half32
        rot_y = rel_x * float(sin_a) + rel_y * float(cos_a) + half32
        inside = ((rot_x >= -0.5) & (rot_y >= -0.5)
                  & (rot_x < mask_size - 0.5) & (rot_y < mask_size - 0.5))
        sx = torch.clamp(rot_x, min=0.0)
        sy = torch.clamp(rot_y, min=0.0)
        fsx, fsy = torch.floor(sx), torch.floor(sy)
        sx0 = torch.clamp(fsx.long(), 0, mask_size - 1)
        sy0 = torch.clamp(fsy.long(), 0, mask_size - 1)
        sx1 = torch.clamp(sx0 + 1, max=mask_size - 1)
        sy1 = torch.clamp(sy0 + 1, max=mask_size - 1)
        fx = sx - sx0.float()
        fy = sy - sy0.float()
        top = _lerp(m[sy0, sx0], m[sy0, sx1], fx)
        bot = _lerp(m[sy1, sx0], m[sy1, sx1], fx)
        val = _lerp(top, bot, fy)
        geom_u8 = torch.where(inside, torch.clamp(round_half_away(val), max=255.0), 0.0)
    else:
        mask_x = round_half_away(rel_x + half32).long()
        mask_y = round_half_away(rel_y + half32).long()
        inside = ((mask_x >= 0) & (mask_y >= 0)
                  & (mask_x < mask_size) & (mask_y < mask_size))
        geom_u8 = torch.where(
            inside,
            m[torch.clamp(mask_y, 0, mask_size - 1), torch.clamp(mask_x, 0, mask_size - 1)],
            0.0)

    # an empty stamp writes nothing below: no read-back to skip it
    ok = geom_u8 > 0
    sel = selected(selection, min_y, max_y + 1, min_x, max_x + 1, dev)
    if sel is not None:
        ok &= sel
    geom = ieee_div(geom_u8, 255.0)
    src_a = f32(color[3]) / f32(255.0)
    strength = geom * float(src_a) * float(f32(np.clip(flow, 0.0, 1.0)))

    window = target[min_y:max_y + 1, min_x:max_x + 1]
    if is_eraser:
        old = ieee_div(window[..., 3].float(), 255.0)
        write = ok & (strength >= 0.01) & (strength > old)
        rgb = torch.where(write[..., None], 0, window[..., 0:3])
        alpha = torch.where(write, (strength * 255.0).to(torch.uint8), window[..., 3])
    else:
        a_u8 = (strength * 255.0).to(torch.uint8)  # truncating cast
        write = ok & (a_u8 >= window[..., 3])
        rgb = torch.stack([torch.where(write, int(color[k]), window[..., k])
                           for k in range(3)], dim=-1)
        alpha = torch.where(write, a_u8, window[..., 3])
    window.copy_(torch.cat([rgb, alpha[..., None]], dim=-1))


def jitter_color(color, hue_jitter: float, brightness_jitter: float,
                 pos, stamp_counter: int):
    """Per-stamp HSL jitter from a u8 (r, g, b) color; prefer
    jitter_color_unit with the ORIGINAL f32 color when available (the
    reference jitters src_r/g/b in 0..1, not the quantized u8)."""
    if hue_jitter <= 0.01 and brightness_jitter <= 0.01:
        return tuple(int(c) for c in color[:3])
    return jitter_color_unit(
        tuple(f32(c) / f32(255.0) for c in color[:3]),
        hue_jitter, brightness_jitter, pos, stamp_counter)


def jitter_color_unit(rgb_unit, hue_jitter: float, brightness_jitter: float,
                      pos, stamp_counter: int):
    """Per-stamp HSL jitter (brush_render.rs:602-636).  rgb_unit: f32 in
    [0, 1] (the brush color before u8 quantization, like the Rust).
    Host numpy on scalars (core/colorspace's numpy path): the colour of one
    stamp is not device work, and all jitter math stays f32 like the Rust."""
    from paintfe_tpu_torch.core.colorspace import hsl_to_rgb, rgb_to_hsl

    r, g, b = (f32(c) for c in rgb_unit[:3])
    h, s, l = rgb_to_hsl(np.asarray(r), np.asarray(g), np.asarray(b))
    h, s, l = f32(h), f32(s), f32(l)
    if hue_jitter > 0.01:
        hh = hash_unit(pos[0] + 0.1, pos[1] + 0.2,
                       (stamp_counter + 777) & 0xFFFFFFFF)
        h = f32(h + (hh * f32(2.0) - f32(1.0)) * f32(hue_jitter) * f32(0.5))
        h = f32(h - np.trunc(h))  # Rust fract()
        if h < 0.0:
            h = f32(h + f32(1.0))
    if brightness_jitter > 0.01:
        bh = hash_unit(pos[0] + 0.3, pos[1] + 0.4,
                       (stamp_counter + 555) & 0xFFFFFFFF)
        l = f32(np.clip(
            l + (bh * f32(2.0) - f32(1.0)) * f32(brightness_jitter) * f32(0.5),
            0.0, 1.0))
    nr, ng, nb = hsl_to_rgb(np.asarray(h), np.asarray(s), np.asarray(l))
    return (int(f32(nr) * 255.0), int(f32(ng) * 255.0), int(f32(nb) * 255.0))


# ---------------------------------------------------------------------------
# Stock tip registry
# ---------------------------------------------------------------------------
#
# The reference embeds 13 stock tip PNGs at compile time
# (assets/brushes/{basic,artistic,texture,vegetation}/ via build.rs ->
# load_embedded_brush_tips, config/brushes.rs:1055-1066).  The registry
# contract (names + categories) is reproduced here; the masks themselves
# are generated procedurally and deterministically — original art, not the
# reference's PNGs — by the JAX package's host numpy calls, copied as they
# are, so the same host gives the same masks.

_STOCK_SIZE = 128


def _disc(s, r=0.48):
    y, x = np.mgrid[0:s, 0:s].astype(f32)
    cx = (s - 1) / 2.0
    d = np.sqrt((x - cx) ** 2 + (y - cx) ** 2) / (s * r)
    return x, y, cx, d


def _hash01(s, seed):
    rng = np.random.default_rng(seed)
    return rng.random((s, s), np.float32)


def _tip_square(s):
    m = np.zeros((s, s), f32)
    m[s // 8:-s // 8, s // 8:-s // 8] = 1.0
    return m


def _tip_diamond(s):
    x, y, cx, _ = _disc(s)
    d = (np.abs(x - cx) + np.abs(y - cx)) / (s * 0.45)
    return np.clip(1.0 - np.maximum(d - 0.95, 0.0) * 12.0, 0.0, 1.0) * (d <= 1.05)


def _tip_chalk(s):
    _, _, _, d = _disc(s)
    grain = _hash01(s, 101)
    body = np.clip(1.0 - d, 0.0, 1.0) ** 0.4
    return body * (grain > 0.35) * (0.55 + 0.45 * _hash01(s, 102))


def _tip_charcoal(s):
    _, _, _, d = _disc(s)
    rough = 1.0 + 0.25 * (_hash01(s, 201) - 0.5)
    body = (d * rough) < 0.95
    return body * (0.4 + 0.6 * (_hash01(s, 202) > 0.15))


def _tip_dry_brush(s):
    x, _, _, d = _disc(s)
    streak_seed = _hash01(s, 301)[0]  # one row -> per-column streak weight
    streaks = np.tile(streak_seed, (s, 1))
    return (d < 1.0) * (streaks > 0.3) * np.clip(1.2 - d, 0.0, 1.0)


def _tip_ink_splatter(s):
    _, _, _, d = _disc(s, 0.3)
    m = np.clip(1.0 - d, 0.0, 1.0) ** 0.25
    rng = np.random.default_rng(401)
    y, x = np.mgrid[0:s, 0:s].astype(f32)
    for _ in range(26):
        px, py = rng.random(2) * s
        pr = (0.5 + rng.random() * 3.0) * s / 64.0
        dist = np.sqrt((x - px) ** 2 + (y - py) ** 2)
        m = np.maximum(m, np.clip(1.0 - dist / pr, 0.0, 1.0) ** 0.5)
    return m


def _tip_spray(s):
    _, _, _, d = _disc(s)
    density = np.exp(-2.5 * d * d)
    return ((_hash01(s, 501) < density * 0.35) * 1.0)


def _tip_watercolor(s):
    x, y, cx, _ = _disc(s)
    ang = np.arctan2(y - cx, x - cx)
    wobble = 1.0 + 0.12 * np.sin(5 * ang + 1.3) + 0.08 * np.sin(9 * ang)
    d = np.sqrt((x - cx) ** 2 + (y - cx) ** 2) / (s * 0.42 * wobble)
    body = np.clip(1.0 - d, 0.0, 1.0) ** 0.3 * 0.75
    rim = np.clip(1.0 - np.abs(d - 0.92) * 8.0, 0.0, 1.0) * 0.25
    return np.clip(body + rim, 0.0, 1.0)


def _tip_blob(s):
    y, x = np.mgrid[0:s, 0:s].astype(f32)
    rng = np.random.default_rng(601)
    field = np.zeros((s, s), f32)
    for _ in range(5):
        px, py = (0.3 + 0.4 * rng.random(2)) * s
        pr = (0.18 + rng.random() * 0.12) * s
        field += np.exp(-(((x - px) ** 2 + (y - py) ** 2) / (pr * pr)))
    return np.clip(field - 0.35, 0.0, 1.0) ** 0.5


def _tip_hatching(s):
    x, y, _, d = _disc(s)
    lines = ((x + y) % 12.0) < 3.0
    return (d < 1.0) * lines * 1.0


def _leafy(s, n_blades, seed, spread, curl):
    """Shared frond/blade painter for the vegetation family."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:s, 0:s].astype(f32)
    m = np.zeros((s, s), f32)
    for b in range(n_blades):
        bx = s * (0.25 + 0.5 * (b + 0.5) / n_blades) + rng.normal(0, s * 0.02)
        lean = (b / max(n_blades - 1, 1) - 0.5) * spread
        for t in np.linspace(0.0, 1.0, 48):
            px = bx + lean * t * s + curl * np.sin(t * 3.0) * s * 0.05
            py = s * (0.95 - 0.85 * t)
            wd = (1.0 - t) * s * 0.02 + 0.7
            dist = np.sqrt((x - px) ** 2 + (y - py) ** 2)
            m = np.maximum(m, np.clip(1.0 - dist / wd, 0.0, 1.0))
    return m


def _tip_fern(s):
    m = _leafy(s, 1, 701, 0.0, 1.0)
    y, x = np.mgrid[0:s, 0:s].astype(f32)
    # leaflets: short angled strokes off the stem
    for t in np.linspace(0.1, 0.9, 12):
        py = s * (0.95 - 0.85 * t)
        px = s * 0.5 + np.sin(t * 3.0) * s * 0.05
        ln = s * 0.16 * (1.0 - t)
        for side in (-1.0, 1.0):
            for u in np.linspace(0.0, 1.0, 14):
                qx = px + side * u * ln
                qy = py - u * ln * 0.35
                dist = np.sqrt((x - qx) ** 2 + (y - qy) ** 2)
                m = np.maximum(m, np.clip(1.0 - dist / 1.1, 0.0, 1.0) * (1.0 - 0.3 * u))
    return m


def _tip_grass(s):
    return _leafy(s, 7, 801, 0.45, 0.3)


def _tip_maple(s):
    x, y, cx, _ = _disc(s)
    ang = np.arctan2(y - cx, x - cx) + np.pi / 2
    r = np.sqrt((x - cx) ** 2 + (y - cx) ** 2) / (s * 0.46)
    lobes = 0.62 + 0.38 * np.abs(np.cos(2.5 * ang)) ** 0.6
    body = (r < lobes) * 1.0
    stem = (np.abs(x - cx) < s * 0.015) & (y > cx) & (r < 1.05)
    return np.clip(body + stem, 0.0, 1.0)


_STOCK_TIPS = {
    # category -> [(name, generator)]
    "basic": [("square", _tip_square), ("diamond", _tip_diamond)],
    "artistic": [
        ("chalk", _tip_chalk), ("charcoal", _tip_charcoal),
        ("dry_brush", _tip_dry_brush), ("ink_splatter", _tip_ink_splatter),
        ("spray", _tip_spray), ("watercolor", _tip_watercolor),
    ],
    "texture": [("blob", _tip_blob), ("hatching", _tip_hatching)],
    "vegetation": [
        ("fern", _tip_fern), ("grass", _tip_grass), ("maple", _tip_maple),
    ],
}


def _title_case(s: str) -> str:
    """build.rs title_case: split on '_'/'-', capitalize, join with space
    ('dry_brush' -> 'Dry Brush')."""
    return " ".join(w[:1].upper() + w[1:] for w in s.replace("-", "_").split("_") if w)


def stock_library() -> BrushTipLibrary:
    """The built-in tip registry: the reference embeds
    assets/brushes/<category>/<name>.png at build time with TITLE-CASED
    display names and categories, both sorted (build.rs:74-115 — category
    dirs sorted, files sorted within; 'dry_brush.png' registers as
    'Dry Brush' in 'Artistic').  Masks are procedural originals; the
    name/category/order contract is what presets and projects written by
    the reference resolve against."""
    lib = BrushTipLibrary()
    for category in sorted(_STOCK_TIPS):
        for name, gen in sorted(_STOCK_TIPS[category]):
            display = _title_case(name)
            cat_display = _title_case(category)
            mask = np.clip(
                _round_half_away(gen(_STOCK_SIZE) * 255.0), 0, 255
            ).astype(np.uint8)
            tip = BrushTipData(display, cat_display, mask, _STOCK_SIZE)
            lib.tips[display] = tip
            lib.categories.setdefault(cat_display, [])
            lib.categories[cat_display].append(display)
    return lib
