"""Distortion effects: pixelate, crystallize, and the inverse-mapped bulge,
twist and dents (paintfe_tpu.ops.effects.distort counterpart).

Behavioral contract: src/ops/effects/distort.rs — jittered-grid Voronoi
crystallize (:26-169), block-center pixelate (:333-373), radial bulge
(:396-437), falloff-rotation twist (:460-500), turbulence-displacement
dents (:248-310).  Bulge, twist and dents are dst(x, y) = src(f(x, y))
with an edge-clamped bilinear gather through the K-warp kernel wrapper
(ops/warp_kernel.py, mode "clamp"), which on a CPU tensor takes its plain
version.  The bulge field is computed in f32 on the image's device in the
JAX package's expression order.  The twist field takes a cos and a sin of
each pixel's rotation: under the transcendental rule (ROADMAP C2) it is
built on the host, each an f64 libm call of the f32 argument rounded once
to f32, and cached per parameter set, so the port's CPU and card outputs
are byte-equal and within 1 of the JAX package's u8.  The dents field's
two turbulence planes depend only on coordinates and the seed: they are
built on the host (utils/hashing, bit-identical to the JAX package) and
cached per parameter set; its pinch and wrap run on the device with a
correctly rounded sqrt and true divides, so dents is byte-equal to the
JAX package.  Pixelate and crystallize are byte-equal to the JAX package;
crystallize's Voronoi map depends only on coordinates and the seed, so it
is built on the host, and only the per-cell sums and the gather of the
averages run on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import as_image, by_frames, coord_grids
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.hashing import hash_f32, turbulence_2d
from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32


def sample_bilinear(img_u8: torch.Tensor, fx: torch.Tensor,
                    fy: torch.Tensor) -> torch.Tensor:
    """Edge-clamped bilinear sample of u8 [..., H, W, 4] at f32 [H', W']
    coordinates, as f32 [..., H', W', 4]; weight order matches
    effects.rs:118-140."""
    h, w = img_u8.shape[-3], img_u8.shape[-2]
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    dx = (fx - x0.float())[..., None]
    dy = (fy - y0.float())[..., None]

    def at(xi, yi):
        cx = torch.clamp(xi, 0, w - 1).long()
        cy = torch.clamp(yi, 0, h - 1).long()
        return img_u8[..., cy, cx, :].float()

    p00 = at(x0, y0)
    p10 = at(x0 + 1, y0)
    p01 = at(x0, y0 + 1)
    p11 = at(x0 + 1, y0 + 1)
    return (
        p00 * (1.0 - dx) * (1.0 - dy)
        + p10 * dx * (1.0 - dy)
        + p01 * (1.0 - dx) * dy
        + p11 * dx * dy
    )


def _bulge_params(amount: float, ox: float, oy: float, h: int, w: int):
    wf, hf = f32(w), f32(h)
    cx = f32(np.clip(ox, 0.0, 1.0)) * max(wf - 1.0, 0.0)
    cy = f32(np.clip(oy, 0.0, 1.0)) * max(hf - 1.0, 0.0)
    max_r = f32(max(max(cx, wf - cx), max(cy, hf - cy), 1.0))
    strength = f32(max(abs(amount), 0.0001))
    return cx, cy, max_r, strength


def bulge_field(amount: float, origin, h: int, w: int, device="cuda"):
    """The bulge's source coordinates and normalized radius, each f32
    [H, W] on `device` (the card unless the caller passes "cpu"): (src_x,
    src_y, norm)."""
    cx, cy, max_r, strength = _bulge_params(
        float(amount), float(origin[0]), float(origin[1]), h, w)
    cx, cy = float(f32(cx)), float(f32(cy))
    xs, ys = coord_grids(h, w, device)
    dx = xs - cx
    dy = ys - cy
    dist = sqrt_f32(dx * dx + dy * dy)
    norm = torch.clamp(ieee_div(dist, float(max_r)), max=1.0)
    falloff = 1.0 - norm
    if amount > 0.0:
        factor = 1.0 - falloff * float(strength) * 0.5
    elif amount < 0.0:
        factor = 1.0 + falloff * float(strength) * 0.5
    else:
        factor = torch.ones_like(falloff)
    return cx + dx * factor, cy + dy * factor, norm


def bulge(img: torch.Tensor, amount: float, origin=(0.5, 0.5),
          mask=None) -> torch.Tensor:
    """Radial scale about origin, inverse-mapped bilinear (distort.rs:396-458)
    of u8 [H, W, 4] or [B, H, W, 4]; pixels at or beyond the radius keep
    the input, and so do masked-out pixels."""
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    h, w = img.shape[-3], img.shape[-2]
    src_x, src_y, norm = bulge_field(float(amount), origin, h, w, img.device)
    warped = gather_bilinear_u8(img, src_x, src_y, mode="clamp")
    out = torch.where((norm >= 1.0)[..., None], img, warped)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Pixelate
# ---------------------------------------------------------------------------


def pixelate(img: torch.Tensor, block_size: int, mask=None) -> torch.Tensor:
    """Sample each block's center pixel (distort.rs:333-373) of u8
    [..., H, W, 4]."""
    bs = max(int(block_size), 2)
    h, w = img.shape[-3], img.shape[-2]
    sx = np.minimum((np.arange(w) // bs) * bs + bs // 2, w - 1)
    sy = np.minimum((np.arange(h) // bs) * bs + bs // 2, h - 1)
    out = (img.index_select(-3, torch.from_numpy(sy).to(img.device))
           .index_select(-2, torch.from_numpy(sx).to(img.device)))
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Crystallize (jittered-grid Voronoi)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def crystallize_cells(cs: float, seed: int, h: int, w: int):
    """The Voronoi map of crystallize: (int64 [H, W] index of each pixel's
    cell, number of cells).  Each pixel takes the nearest jittered seed of
    the 3x3 cells around its own, scanned in the reference's order with a
    strict < (ties keep the first seen), in f32 as the JAX package's
    general form."""
    cs = f32(max(cs, 2.0))
    cells_x = max(int(np.ceil(f32(w) / cs)), 1)
    cells_y = max(int(np.ceil(f32(h) / cs)), 1)
    cxs = np.arange(cells_x, dtype=np.uint32)[None, :] + np.zeros((cells_y, 1), np.uint32)
    cys = np.arange(cells_y, dtype=np.uint32)[:, None] + np.zeros((1, cells_x), np.uint32)
    jx = hash_f32(cxs, cys, seed)
    jy = hash_f32(cxs, cys, (seed + 77) & 0xFFFFFFFF)
    seed_x = (cxs.astype(f32) * cs + jx * cs).reshape(-1)
    seed_y = (cys.astype(f32) * cs + jy * cs).reshape(-1)

    xs = np.arange(w, dtype=f32)[None, :]
    ys = np.arange(h, dtype=f32)[:, None]
    gcx = (xs / cs).astype(np.int32)
    gcy = (ys / cs).astype(np.int32)
    px = xs + f32(0.5)
    py = ys + f32(0.5)
    best_dist = np.full((h, w), np.inf, f32)
    best_idx = np.zeros((h, w), np.int64)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nx = gcx + dx
            ny = gcy + dy
            valid = (nx >= 0) & (ny >= 0) & (nx < cells_x) & (ny < cells_y)
            idx = np.clip(ny, 0, cells_y - 1) * cells_x + np.clip(nx, 0, cells_x - 1)
            sx = seed_x[idx]
            sy = seed_y[idx]
            d = (px - sx) * (px - sx) + (py - sy) * (py - sy)
            d = np.where(valid, d, f32(np.inf))
            take = d < best_dist
            best_dist = np.where(take, d, best_dist)
            best_idx = np.where(take, idx, best_idx)
    return best_idx, cells_x * cells_y


def crystallize(img: torch.Tensor, cell_size: float, seed: int = 42,
                mask=None) -> torch.Tensor:
    """Jittered-grid Voronoi cell averaging (distort.rs:26-169) of u8
    [..., H, W, 4]: per-cell integer sums (index_add_ on int64, exact and
    deterministic), each rounded half up as (2s + c) // (2c), the JAX
    package's integer identity."""
    h, w = img.shape[-3], img.shape[-2]
    best_idx, n_cells = crystallize_cells(float(max(cell_size, 2.0)), int(seed), h, w)
    cell = torch.from_numpy(best_idx).to(img.device)
    flat_cell = cell.reshape(-1)
    counts = torch.zeros(n_cells, dtype=torch.int64, device=img.device)
    counts.index_add_(0, flat_cell, torch.ones_like(flat_cell))
    safe_c = torch.clamp(counts, min=1)[:, None]

    def run(x):
        frames = x.reshape((-1, h * w, 4)).long()
        sums = torch.zeros((frames.shape[0], n_cells, 4), dtype=torch.int64, device=x.device)
        sums.index_add_(1, flat_cell, frames)
        avg = ((2 * sums + safe_c) // (2 * safe_c)).to(torch.uint8)
        avg = torch.where((counts > 0)[:, None], avg, 0)
        return avg[:, cell].reshape(x.shape)

    return _masked(img, by_frames(run, img), mask)


# ---------------------------------------------------------------------------
# Twist
# ---------------------------------------------------------------------------


def _twist_params(angle_deg: float, ox: float, oy: float, h: int, w: int):
    wf, hf = f32(w), f32(h)
    cx = f32(np.clip(ox, 0.0, 1.0)) * max(wf - 1.0, 0.0)
    cy = f32(np.clip(oy, 0.0, 1.0)) * max(hf - 1.0, 0.0)
    mx = max(cx, wf - cx)
    my = max(cy, hf - cy)
    max_r = f32(max(np.sqrt(f32(mx * mx + my * my)), 1.0))
    twist_amount = f32(f32(angle_deg) * (f32(np.pi) / f32(180.0)))
    return cx, cy, max_r, twist_amount


@functools.lru_cache(maxsize=2)  # 66 MB an entry at 3840x2160
def twist_field(angle_deg: float, ox: float, oy: float, h: int, w: int):
    """The twist's source coordinates (src_x, src_y), f32 [H, W] numpy
    arrays built on the host: the rotation angle in f32 in the JAX
    package's order, its cos and sin each an f64 libm call rounded once
    to f32 (ROADMAP C2)."""
    cx, cy, max_r, twist_amount = _twist_params(angle_deg, ox, oy, h, w)
    cx, cy = f32(cx), f32(cy)
    dx = np.arange(w, dtype=f32)[None, :] - cx
    dy = np.arange(h, dtype=f32)[:, None] - cy
    sq = dx * dx + dy * dy
    dist = np.sqrt(sq.astype(np.float64)).astype(f32)
    rotation = f32(twist_amount) * (f32(1.0) - dist / f32(max_r))
    cos_r = np.cos(rotation.astype(np.float64)).astype(f32)
    sin_r = np.sin(rotation.astype(np.float64)).astype(f32)
    src_x = np.ascontiguousarray(cx + dx * cos_r - dy * sin_r, f32)
    src_y = np.ascontiguousarray(cy + dx * sin_r + dy * cos_r, f32)
    return src_x, src_y


def twist(img: torch.Tensor, angle_deg: float, origin=(0.5, 0.5),
          mask=None) -> torch.Tensor:
    """Rotation by angle*(1-dist/max_r) about origin (distort.rs:460-500)
    of u8 [..., H, W, 4]: one K-warp launch (mode "clamp") for the whole
    batch on the card."""
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    h, w = img.shape[-3], img.shape[-2]
    src_x, src_y = twist_field(float(angle_deg), float(origin[0]), float(origin[1]), h, w)
    warped = gather_bilinear_u8(img, torch.from_numpy(src_x).to(img.device),
                                torch.from_numpy(src_y).to(img.device), mode="clamp")
    return _masked(img, warped, mask)


# ---------------------------------------------------------------------------
# Dents
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=2)  # 66 MB an entry at 3840x2160
def dents_noise(scale: float, seed: int, octaves: int, roughness: float, h: int, w: int):
    """The two turbulence planes of dents, each f32 [H, W] in [-1, 1]
    (numpy, on the host): turbulence_2d at the pixel coordinates over
    max(scale, 0.5), seeds `seed` and `seed + 9999`, octaves clipped to
    [1, 8]."""
    inv_scale = f32(1.0) / f32(max(scale, 0.5))
    oct_n = int(np.clip(octaves, 1, 8))
    xs = np.arange(w, dtype=f32)[None, :] * np.ones((h, 1), f32)
    ys = np.arange(h, dtype=f32)[:, None] * np.ones((1, w), f32)
    sx, sy = xs * inv_scale, ys * inv_scale
    nx = turbulence_2d(sx, sy, seed, oct_n, roughness) * f32(2.0) - f32(1.0)
    ny = turbulence_2d(sx, sy, (seed + 9999) & 0xFFFFFFFF, oct_n, roughness) \
        * f32(2.0) - f32(1.0)
    return np.ascontiguousarray(nx, f32), np.ascontiguousarray(ny, f32)


def dents_field(scale, amount, seed, octaves, roughness, pinch, wrap, h, w,
                device="cuda"):
    """The dents' source coordinates (src_x, src_y), f32 [H, W] on
    `device` (the card unless the caller passes "cpu"; CUDA with no card
    raises): the host noise planes uploaded, the pinch and the wrap in the
    JAX package's f32 order on the device."""
    from paintfe_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    nx_host, ny_host = dents_noise(float(scale), int(seed), int(octaves),
                                   float(roughness), h, w)
    nx = torch.from_numpy(nx_host).to(device)
    ny = torch.from_numpy(ny_host).to(device)
    xs, ys = coord_grids(h, w, device)
    if pinch:
        cx = f32(w) * f32(0.5)
        cy = f32(h) * f32(0.5)
        dx = xs - float(cx)
        dy = ys - float(cy)
        dist = torch.clamp(sqrt_f32(dx * dx + dy * dy), min=1.0)
        factor = (1.0 - ieee_div(dist, float(max(cx, cy)))) * 0.5
        nx = nx + dx / dist * factor
        ny = ny + dy / dist * factor
    amt, sc = float(f32(amount)), float(f32(scale))
    src_x = xs + nx * amt * sc
    src_y = ys + ny * amt * sc
    if wrap:
        src_x = src_x - torch.floor(ieee_div(src_x, float(w))) * float(w)
        src_y = src_y - torch.floor(ieee_div(src_y, float(h))) * float(h)
    return src_x.contiguous(), src_y.contiguous()


def dents(img, scale, amount, seed=42, octaves=2, roughness=0.5, pinch=False,
          wrap=False, mask=None, device="cuda") -> torch.Tensor:
    """Turbulence-field displacement warp (distort.rs:248-310) of u8
    [..., H, W, 4] (a tensor, or numpy moved to `device`): one K-warp
    launch (mode "clamp") for the whole batch on the card."""
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    x = as_image(img, device)
    h, w = x.shape[-3], x.shape[-2]
    src_x, src_y = dents_field(scale, amount, seed, octaves, roughness, bool(pinch),
                               bool(wrap), h, w, x.device)
    return _masked(x, gather_bilinear_u8(x, src_x, src_y, mode="clamp"), mask)
