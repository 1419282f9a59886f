"""Flood fill / magic wand (paintfe_tpu.ops.fill counterpart).

Behavioral contract: the reference's GPU flood fill (src/gpu/shaders.rs:
441-752 FLOOD_* — per-pixel color distance to target, seed init, iterative
relaxation steps with 4/8-connectivity) and the CPU fill path's perceptual
sRGB->linear color distance + AA threshold mask
(src/ui/panels/tools/behavior/raster/fill_magic.rs:78-132, 415-467).

The distance maps and the reachability loop run on a torch device, the
card unless the caller passes "cpu", as plain torch: the JAX package runs
them in XLA, outside any Pallas kernel.  The sRGB -> linear power is
taken of an input that is one of 256 values (u8 / 255), so it is a
256-entry host table (ROADMAP C2): an f64 libm pow of the f32 base to the
exponent rounded to f32 first, rounded once to f32, which equals
`jnp.power` on every input.  Divides are true divides (`ieee_div`), the
sqrt correctly rounded (`sqrt_f32`).  Contiguous reachability spreads
whole passable runs along rows and columns with cummax scans until
nothing changes (one host sync an iteration): O(#path direction changes)
iterations, and the fixpoint is the exact connected component.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32


@functools.lru_cache(maxsize=1)
def srgb_to_linear_table() -> np.ndarray:
    """f32[256]: the JAX package's _srgb_to_linear of u8 / 255.  Below
    0.04045 one f32 divide by 12.92; above, the f32 base (v + 0.055) / 1.055
    raised to f32(2.4) in f64 and rounded once to f32 (correctly rounded,
    as XLA's pow is on these inputs)."""
    v = np.arange(256, dtype=f32) / f32(255.0)
    low = v / f32(12.92)
    base = (v + f32(0.055)) / f32(1.055)
    high = np.power(base.astype(np.float64), np.float64(f32(2.4))).astype(f32)
    return np.where(v <= f32(0.04045), low, high).astype(f32)


def _linear(u8: torch.Tensor) -> torch.Tensor:
    table = torch.from_numpy(srgb_to_linear_table()).to(u8.device)
    return table[u8.long()]


def perceptual_distance_map(img: torch.Tensor, target) -> torch.Tensor:
    """u8 distance of every pixel to `target` (RGBA u8 [4]) — premultiplied
    linear-light luma+chroma metric (fill_magic.rs:84-129).  img: u8
    [H, W, 4] tensor; the result is u8 [H, W] on its device."""
    t_u8 = torch.as_tensor(np.asarray(target, np.uint8), device=img.device)
    a = ieee_div(img[..., 3].float(), 255.0)
    ta = ieee_div(t_u8[3].float(), 255.0)
    lin = _linear(img[..., 0:3]) * a[..., None]
    tlin = _linear(t_u8[0:3]) * ta
    d = lin - tlin
    dr, dg, db = d[..., 0], d[..., 1], d[..., 2]
    dluma = torch.abs(0.2126 * dr + 0.7152 * dg + 0.0722 * db)
    dchroma = sqrt_f32(
        0.5 * (dr - dg) * (dr - dg) + 0.5 * (dg - db) * (dg - db) + 0.5 * (db - dr) * (db - dr)
    )
    color_term = torch.clamp(dluma * 0.7 + dchroma * 0.8, 0.0, 1.0)
    alpha_term = torch.abs(a - ta)
    dist = torch.floor(torch.maximum(color_term, alpha_term) * 255.0 + 0.5)
    both_clear = (ta <= 0.0) & (a <= 0.0)
    return torch.where(both_clear, 0.0, torch.clamp(dist, 0, 255)).to(torch.uint8)


def legacy_distance_map(img: torch.Tensor, target) -> torch.Tensor:
    """u8 max-component |Δ| over RGBA (fill_magic.rs pixel_color_distance,
    LegacyRgba): the FILL tool pins this metric because the perceptual one
    can leave 1-px gaps at fill boundaries (fill_magic.rs:1267-1273).
    Both-transparent pixels are distance 0."""
    t = torch.as_tensor(np.asarray(target, np.int16), device=img.device)
    d = torch.abs(img.to(torch.int16) - t).amax(dim=-1)
    both_clear = (t[3] == 0) & (img[..., 3] == 0)
    return torch.where(both_clear, 0, d).to(torch.uint8)


def tolerance_threshold_u8(tolerance: float) -> int:
    n = min(max(tolerance / 100.0, 0.0), 1.0)
    return int(min(max(np.floor(n * 255.0 + 0.5), 0.0), 255.0))


def threshold_alpha(distance: torch.Tensor, threshold: int, anti_aliased: bool):
    """255 inside, 128 on the 1-unit AA fringe, 0 outside (fill_magic.rs:415)."""
    inside = distance <= threshold
    if not anti_aliased:
        return torch.where(inside, 255, 0).to(torch.uint8)
    return torch.where(
        inside, 255, torch.where(distance == min(threshold + 1, 255), 128, 0)
    ).to(torch.uint8)


_NEG_BIG = -(1 << 30)


def _cummax(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def _reach_loop(passable: torch.Tensor, reach0: torch.Tensor, connectivity8: bool):
    """Reachable set + iteration count (scanline relaxation), the JAX
    package's _reach_loop: each iteration floods whole horizontal then
    vertical passable runs.  A pixel x is in a reached run iff the last
    reached index at-or-before x beats the last wall index at-or-before x
    (and mirrored for the other direction).  The wall scans are
    loop-invariant; the loop stops when an iteration changes nothing (one
    host sync an iteration)."""
    h, w = passable.shape
    dev = passable.device
    wall = ~passable
    col = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    rowi = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    big = torch.tensor(_NEG_BIG, dtype=torch.int32, device=dev)
    lw_x = _cummax(torch.where(wall, col, big), 1)
    nw_x = _cummax(torch.where(wall, -col, big), 1, reverse=True)
    lw_y = _cummax(torch.where(wall, rowi, big), 0)
    nw_y = _cummax(torch.where(wall, -rowi, big), 0, reverse=True)

    def spread_x(r):
        hit = _cummax(torch.where(r, col, big), 1) > lw_x
        hit |= _cummax(torch.where(r, -col, big), 1, reverse=True) > nw_x
        return passable & hit

    def spread_y(r):
        hit = _cummax(torch.where(r, rowi, big), 0) > lw_y
        hit |= _cummax(torch.where(r, -rowi, big), 0, reverse=True) > nw_y
        return passable & hit

    def diag(r):
        grown = r.clone()
        grown[1:, 1:] |= r[:-1, :-1]
        grown[1:, :-1] |= r[:-1, 1:]
        grown[:-1, 1:] |= r[1:, :-1]
        grown[:-1, :-1] |= r[1:, 1:]
        return grown & passable

    r = reach0 & passable
    n = 0
    while True:
        nr = spread_y(spread_x(r))
        if connectivity8:
            # several diagonal + run-spread sub-steps per fixpoint check, as
            # the JAX package: a diagonal staircase advances 4 pixels an
            # iteration
            for _ in range(4):
                nr = spread_y(spread_x(diag(nr)))
        n += 1
        changed = bool(torch.any(nr != r))
        r = nr
        if not changed:
            return r, n


def _reachability_iters(passable: torch.Tensor, seed_y: int, seed_x: int,
                        connectivity8: bool = False):
    reach0 = torch.zeros_like(passable)
    reach0[seed_y, seed_x] = True
    return _reach_loop(passable, reach0, connectivity8)


def _reachability_seeded(passable: torch.Tensor, seeds: torch.Tensor,
                         connectivity8: bool = False) -> torch.Tensor:
    """Flood from an arbitrary seed MASK (the fringe pass of the bottleneck
    wand starts from the already-flooded core)."""
    return _reach_loop(passable, seeds & passable, connectivity8)[0]


def _reachability(passable: torch.Tensor, seed_y: int, seed_x: int,
                  connectivity8: bool = False) -> torch.Tensor:
    return _reachability_iters(passable, seed_y, seed_x, connectivity8)[0]


def magic_wand_mask(img, x: int, y: int, tolerance: float, contiguous: bool = True,
                    anti_aliased: bool = True, connectivity8: bool = False,
                    metric: str = "perceptual", device="cuda") -> np.ndarray:
    """Selection mask u8 [H, W] (numpy) for the magic wand (and, with
    metric="legacy", the fill tool), computed on `device`.

    Contiguous selections follow the reference's Dijkstra MINIMAX
    (bottleneck) semantics (fill_magic.rs:942-1019): a pixel's alpha comes
    from the minimax per-step distance along the best path from the seed,
    not its own distance.  In the thresholded domain that is two-level:
    pixels reachable through the core (every step <= thr) are 255; pixels
    reachable only by crossing the AA fringe (a step == thr+1) are 128 —
    including in-tolerance pockets enclosed by a fringe ring."""
    from paintfe_tpu_torch.utils.device import resolve_device

    host = np.asarray(img, np.uint8)
    target = host[y, x]
    t = torch.from_numpy(np.ascontiguousarray(host)).to(resolve_device(device))
    dmap = (perceptual_distance_map if metric == "perceptual"
            else legacy_distance_map)
    dist = dmap(t, target)
    thr = tolerance_threshold_u8(tolerance)
    if not contiguous:
        return threshold_alpha(dist, thr, anti_aliased).cpu().numpy()
    reach_core = _reachability(dist <= thr, y, x, connectivity8)
    if not anti_aliased:
        return torch.where(reach_core, 255, 0).to(torch.uint8).cpu().numpy()
    fringe_pass = dist <= min(thr + 1, 255)
    seeds = reach_core.clone()
    seeds[y, x] = True
    reach_fringe = _reachability_seeded(fringe_pass, seeds, connectivity8)
    mask = torch.where(reach_core, 255, torch.where(reach_fringe, 128, 0))
    return mask.to(torch.uint8).cpu().numpy()


def bucket_fill(img, x: int, y: int, color, tolerance: float = 25.0,
                contiguous: bool = True, anti_aliased: bool = False,
                device="cuda") -> np.ndarray:
    """Fill with `color` where the fill mask covers; AA fringe alpha-blends.

    The FILL tool pins the LegacyRgba max-component metric with 4-connected
    flood (fill_magic.rs:1267-1273 — perceptual distance can leave 1-px
    gaps at fill boundaries) and defaults anti_aliased off
    (FillToolState::default, state.rs:871-877).  The mask is computed on
    `device`, the blend on the host as in the JAX package."""
    mask = magic_wand_mask(img, x, y, tolerance, contiguous, anti_aliased,
                           metric="legacy", device=device)
    img_np = np.asarray(img, np.uint8)
    cov = mask.astype(f32)[..., None] / f32(255.0)
    color_v = np.asarray(color, f32)
    out = img_np.astype(f32) * (1.0 - cov) + color_v[None, None, :] * cov
    return np.clip(np.floor(out + f32(0.5)), 0, 255).astype(np.uint8)
