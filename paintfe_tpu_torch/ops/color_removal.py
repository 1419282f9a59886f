"""Color-to-alpha and the smart contiguous eraser
(paintfe_tpu.ops.color_removal counterpart).

Behavioral contract: src/ops/color_removal.rs — ColorToAlphaSettings
(defaults :20-28), color_to_alpha_core (:32-140: max-channel distance ->
contribution ramp over [tolerance, tolerance+softness], luminance
protection, RGB recovery via inverse un-premultiply, spill suppression),
compute/apply color removal two-phase flow (:161+).

Host numpy as in the JAX package, except the contiguous flood of
flood_select (and so of smart_contiguous_erase), which is fill's
reachability loop on `device`, the card unless the caller passes "cpu".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from paintfe_tpu_torch.ops.fill import _reachability
from paintfe_tpu_torch.utils.device import resolve_device

f32 = np.float32


@dataclasses.dataclass
class ColorToAlphaSettings:
    target: tuple = (255, 0, 0)
    tolerance: float = 18.0
    softness: float = 35.0
    strength: float = 1.0
    spill_suppression: float = 0.35
    alpha_floor: float = 0.0
    alpha_ceiling: float = 1.0
    protect_luminance: float = 0.15


def _luma(r, g, b):
    return r * f32(0.2126) + g * f32(0.7152) + b * f32(0.0722)


def color_to_alpha(img: np.ndarray, settings: Optional[ColorToAlphaSettings] = None,
                   mask: Optional[np.ndarray] = None) -> np.ndarray:
    s = settings or ColorToAlphaSettings()
    img = np.asarray(img, np.uint8)
    out = img.copy()

    target = np.asarray(s.target, f32)
    tolerance = f32(np.clip(s.tolerance / 255.0, 0.0, 1.0))
    softness = f32(max(s.softness / 255.0, 0.001))
    strength = f32(np.clip(s.strength, 0.0, 1.0))
    spill = f32(np.clip(s.spill_suppression, 0.0, 1.0))
    alpha_floor = f32(np.clip(s.alpha_floor, 0.0, 1.0))
    alpha_ceiling = f32(np.clip(s.alpha_ceiling, alpha_floor, 1.0))
    protect = f32(np.clip(s.protect_luminance, 0.0, 1.0))
    target_luma = _luma(target[0], target[1], target[2])

    r = img[..., 0].astype(f32)
    g = img[..., 1].astype(f32)
    b = img[..., 2].astype(f32)
    orig_a = img[..., 3].astype(f32)

    max_d = np.maximum(
        np.abs(r - target[0]) / f32(255.0),
        np.maximum(np.abs(g - target[1]) / f32(255.0), np.abs(b - target[2]) / f32(255.0)),
    )
    contribution = f32(1.0) - np.clip((max_d - tolerance) / softness, 0.0, 1.0)
    if protect > 0.0:
        luma_delta = np.clip(np.abs(_luma(r, g, b) - target_luma) / f32(255.0), 0.0, 1.0)
        contribution = contribution * (f32(1.0) - np.clip(luma_delta * protect, 0.0, 1.0))

    removal = np.clip(contribution * strength, 0.0, 1.0)
    active = (img[..., 3] > 0) & (removal > 0.0)
    if mask is not None:
        active &= np.asarray(mask) > 0

    new_a_f = np.clip((orig_a / f32(255.0)) * (f32(1.0) - removal), alpha_floor, alpha_ceiling)
    safe_orig = np.where(orig_a > 0, orig_a / f32(255.0), 1.0)
    kept = np.clip(new_a_f / safe_orig, 0.0, 1.0)
    new_a = np.clip(np.floor(new_a_f * f32(255.0) + f32(0.5)), 0, 255).astype(np.uint8)

    zeroed = (new_a == 0) | (kept < 0.001)
    safe_kept = np.where(zeroed, 1.0, kept)

    def recover(orig, tch):
        return np.clip((orig - tch * removal) / safe_kept, 0.0, 255.0)

    nr, ng, nb = recover(r, target[0]), recover(g, target[1]), recover(b, target[2])
    if spill > 0.0:
        amount = np.clip(spill * contribution * (f32(1.0) - kept), 0.0, 1.0)
        if target[0] > 0:
            nr = nr * (f32(1.0) - amount)
        if target[1] > 0:
            ng = ng * (f32(1.0) - amount)
        if target[2] > 0:
            nb = nb * (f32(1.0) - amount)

    def rnd(v):
        return np.floor(v + f32(0.5)).astype(np.uint8)

    out[..., 0] = np.where(active, np.where(zeroed, 0, rnd(nr)), out[..., 0])
    out[..., 1] = np.where(active, np.where(zeroed, 0, rnd(ng)), out[..., 1])
    out[..., 2] = np.where(active, np.where(zeroed, 0, rnd(nb)), out[..., 2])
    out[..., 3] = np.where(active, new_a, out[..., 3])
    return out


def flood_select(pixels: np.ndarray, start_x: int, start_y: int,
                 tolerance: float, selection: Optional[np.ndarray] = None,
                 contiguous: bool = True, device="cuda") -> np.ndarray:
    """The smart-eraser core mask (color_removal.rs:185-256): squared
    Euclidean RGB distance <= (tolerance*2.55)^2 (UI 0-100 -> 0-255 scale),
    4-connected flood, fully-transparent pixels auto-included and
    traversable, transparent seed -> empty, selection-mask zeros block."""
    h, w = pixels.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    if not (0 <= start_x < w and 0 <= start_y < h):
        return mask
    if selection is not None and selection[start_y, start_x] == 0:
        return mask
    if pixels[start_y, start_x, 3] == 0:
        return mask  # clicked a fully transparent pixel: no-op
    seed = pixels[start_y, start_x, :3].astype(f32)
    # f32 chain exactly like the reference (color_removal.rs: `(tolerance
    # * 2.55) * (tolerance * 2.55)` with a 2.55f32 literal) — computing
    # the product in f64 first lands 1 ulp off and flips membership for
    # pixels exactly at the threshold
    tol = f32(tolerance) * f32(2.55)
    tol_sq = tol * tol
    d = pixels[..., :3].astype(f32) - seed[None, None, :]
    dist_sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    member = (pixels[..., 3] == 0) | (dist_sq <= tol_sq)
    if selection is not None:
        member &= selection > 0
    if not contiguous:
        member &= pixels[..., 3] > 0  # global match skips transparent
        mask[member] = 255
        mask[start_y, start_x] = 255
        return mask
    passable = torch.from_numpy(member).to(resolve_device(device))
    reach = _reachability(passable, start_y, start_x).cpu().numpy()
    mask[reach] = 255
    mask[start_y, start_x] = 255  # seed included unconditionally
    return mask


def _ring_distance(core: np.ndarray, smoothness: int,
                   selection: Optional[np.ndarray]) -> np.ndarray:
    """BFS ring distance from the core edge (color_removal.rs:260-333):
    0 = core, 1..smoothness = dilated fringe, -1 = outside."""
    h, w = core.shape
    dist = np.where(core, 0, -1).astype(np.int32)
    frontier = core
    ok = np.ones((h, w), bool) if selection is None else (selection > 0)
    for ring in range(1, int(smoothness) + 1):
        grown = np.zeros((h, w), bool)
        grown[1:, :] |= frontier[:-1, :]
        grown[:-1, :] |= frontier[1:, :]
        grown[:, 1:] |= frontier[:, :-1]
        grown[:, :-1] |= frontier[:, 1:]
        new = grown & (dist == -1) & ok
        if not new.any():
            break
        dist[new] = ring
        frontier = new
    return dist


def smart_contiguous_erase(pixels: np.ndarray, start_x: int, start_y: int,
                           tolerance: float, smoothness: int = 2,
                           selection: Optional[np.ndarray] = None,
                           contiguous: bool = True, device="cuda") -> np.ndarray:
    """The smart eraser (color_removal.rs:161-418): flood-select the core,
    dilate by `smoothness` 4-connected rings, then per pixel remove
    removal = (1 - max-channel distance to the seed) faded linearly by
    ring distance (1 - dist/(smoothness+1)); alpha = round(a*(1-removal)),
    RGB recovered by inverting the seed premultiplication."""
    out = pixels.copy()
    region = flood_select(pixels, start_x, start_y, tolerance,
                          selection=selection, contiguous=contiguous, device=device)
    if not region.any():
        return out
    dist = _ring_distance(region > 0, smoothness, selection)
    in_mask = dist >= 0
    seed = pixels[start_y, start_x, :3].astype(f32)

    a = pixels[..., 3]
    active = in_mask & (a > 0)
    rgb = pixels[..., :3].astype(f32)
    dd = np.abs(rgb - seed[None, None, :]) / f32(255.0)
    max_d = dd.max(axis=-1)
    removal = f32(1.0) - max_d
    if smoothness > 0:
        fade = f32(1.0) - dist.astype(f32) / f32(float(smoothness) + 1.0)
        removal = np.where(dist > 0, removal * fade, removal)
    removal = np.clip(removal, 0.0, 1.0)
    active &= removal >= 0.004  # negligible change skipped (< 1/255)

    new_a_f = (a.astype(f32) / f32(255.0)) * (f32(1.0) - removal)
    new_a = np.clip(np.floor(new_a_f * f32(255.0) + f32(0.5)), 0, 255
                    ).astype(np.uint8)
    kept = f32(1.0) - removal
    safe_kept = np.where(kept < 0.001, f32(1.0), kept)
    rec = (rgb - seed[None, None, :] * removal[..., None]) / safe_kept[..., None]
    rec = np.clip(np.floor(rec + f32(0.5)), 0, 255).astype(np.uint8)
    # kept < 0.001 keeps the original channel (truncating `orig as u8`)
    rec = np.where((kept < 0.001)[..., None], pixels[..., :3], rec)

    zeroed = new_a == 0  # fully removed -> (0,0,0,0)
    for c in range(3):
        out[..., c] = np.where(
            active, np.where(zeroed, 0, rec[..., c]), out[..., c])
    out[..., 3] = np.where(active, new_a, out[..., 3])
    return out
