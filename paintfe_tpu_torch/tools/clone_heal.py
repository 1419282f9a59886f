"""Clone-stamp and healing (content-aware) brushes
(paintfe_tpu.tools.clone_heal counterpart).

Behavioral contract: src/ui/panels/tools/behavior/raster/clone_heal.rs —
clone samples the active layer at a fixed offset with the brush falloff and
max-alpha accumulation into the preview layer (:6-99); heal replaces each
pixel with the average of 24 ring samples at two radii (0.75/1.0 of the
sample radius) with a per-pixel hash-seeded angle offset to break grid
artifacts (:142-255); both stroke via dense 1-px line stepping (:101-132,
:262-292).

Each stamp is torch over the brush bounding box on the preview's device:
`preview` and `source` are u8 [H, W, 4] tensors there, and `preview` is
written in place.  The heal's ring coordinates take a cos and a sin of a
per-pixel angle: the host builds them with the JAX package's numpy calls
(ROADMAP C2) and uploads the integer sample indices, and the device
gathers and averages.  Strokes loop the dense steps on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.tools.brush import Brush
from paintfe_tpu_torch.tools.stamp import check_target, resident, selected
from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32
TAU = f32(2.0 * np.pi)


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    """Rust f32::round — half away from zero ((-0.5).round() == -1, where
    floor(v + 0.5) would give 0)."""
    return torch.where(v >= 0.0, torch.floor(v + 0.5), torch.ceil(v - 0.5)).long()


def _round_half_away_host(v) -> np.ndarray:
    return np.where(v >= 0.0, np.floor(v + f32(0.5)),
                    np.ceil(v - f32(0.5))).astype(np.int64)


def _bbox(cx, cy, radius, w, h):
    min_x = int(max(cx - radius, 0.0))
    max_x = min(int(cx + radius), w - 1)
    min_y = int(max(cy - radius, 0.0))
    max_y = min(int(cy + radius), h - 1)
    return min_x, max_x, min_y, max_y


def _grid(min_x, max_x, min_y, max_y, device):
    """f32 pixel coordinates (gx, gy) of the box, [bh, bw] each."""
    xs = torch.arange(min_x, max_x + 1, device=device, dtype=torch.float32)
    ys = torch.arange(min_y, max_y + 1, device=device, dtype=torch.float32)
    shape = (ys.numel(), xs.numel())
    return xs[None, :].expand(shape), ys[:, None].expand(shape)


def _distance(gx, gy, cx, cy):
    dx = gx - float(f32(cx))
    dy = gy - float(f32(cy))
    return sqrt_f32(dx * dx + dy * dy)


def clone_stamp_circle(brush: Brush, preview: torch.Tensor, source: torch.Tensor,
                       pos, offset, selection=None):
    """One clone stamp into `preview` (straight alpha), sampling `source`
    at `pos + offset` (clone_heal.rs:6-99).  Mutates `preview` in place."""
    check_target(preview)
    dev = preview.device
    h, w = source.shape[:2]
    cx, cy = float(pos[0]), float(pos[1])
    radius = brush.properties.size / 2.0
    min_x, max_x, min_y, max_y = _bbox(cx, cy, radius, w, h)
    if max_x < min_x or max_y < min_y:
        return

    gx, gy = _grid(min_x, max_x, min_y, max_y, dev)
    dist = _distance(gx, gy, cx, cy)
    geom = brush.compute_brush_alpha(dist, f32(radius))
    ok = (dist <= radius) & (geom >= 0.01)
    sel = selected(selection, min_y, max_y + 1, min_x, max_x + 1, dev)
    if sel is not None:
        ok &= sel

    # source coords: round half AWAY from zero (Rust f32::round) — plain
    # floor(x+0.5) rounds -0.5 to 0 where Rust gives -1, an off-by-one on
    # negative source coordinates
    sx = _round_half_away(gx + float(f32(offset[0])))
    sy = _round_half_away(gy + float(f32(offset[1])))
    ok &= (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    src = source[torch.clamp(sy, 0, h - 1), torch.clamp(sx, 0, w - 1)]

    brush_alpha = geom * ieee_div(src[..., 3].float(), 255.0)
    window = preview[min_y:max_y + 1, min_x:max_x + 1]
    old_alpha = ieee_div(window[..., 3].float(), 255.0)
    write = ok & (brush_alpha >= old_alpha)

    rgb = torch.where(write[..., None], src[..., 0:3], window[..., 0:3])
    alpha = torch.where(write, (brush_alpha * 255.0).to(torch.uint8), window[..., 3])
    window.copy_(torch.cat([rgb, alpha[..., None]], dim=-1))


def _ring_indices(min_x, max_x, min_y, max_y, w, h, sample_radius, num_samples):
    """The heal's ring sample pixels on the host, as the JAX package
    computes them (clone_heal.rs:206-230): int32 [2 * num_samples, bh, bw]
    flat indices y * w + x into the source, -1 where the sample falls off
    the canvas."""
    xs = np.arange(min_x, max_x + 1)
    ys = np.arange(min_y, max_y + 1)
    gx, gy = np.meshgrid(xs, ys)
    # per-pixel angle offset from the wrapping-hash seed (clone_heal.rs:206-208)
    seed = (gx.astype(np.uint32) * np.uint32(1619)
            + gy.astype(np.uint32) * np.uint32(3929))
    angle_off = seed.astype(f32) / f32(np.float64(0xFFFFFFFF)) * TAU
    out = np.empty((2 * num_samples,) + gx.shape, np.int32)
    k = 0
    for i in range(num_samples):
        angle = angle_off + f32(i / num_samples) * TAU
        for rr in (sample_radius * 0.75, sample_radius):
            sx = _round_half_away_host(gx.astype(f32) + np.cos(angle) * f32(rr))
            sy = _round_half_away_host(gy.astype(f32) + np.sin(angle) * f32(rr))
            valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
            out[k] = np.where(valid, sy * w + sx, -1)
            k += 1
    return out


def heal_circle(brush: Brush, preview: torch.Tensor, source: torch.Tensor, pos,
                sample_radius: float, selection=None, num_samples: int = 24):
    """One healing stamp: each brushed pixel becomes the mean of ring samples
    around it (clone_heal.rs:142-255).  Mutates `preview` in place."""
    check_target(preview)
    dev = preview.device
    h, w = source.shape[:2]
    cx, cy = float(pos[0]), float(pos[1])
    radius = brush.properties.size / 2.0
    min_x, max_x, min_y, max_y = _bbox(cx, cy, radius, w, h)
    if max_x < min_x or max_y < min_y:
        return

    gx, gy = _grid(min_x, max_x, min_y, max_y, dev)
    dist = _distance(gx, gy, cx, cy)

    # hardness-aware falloff (clone_heal.rs:193-203)
    t = torch.clamp(ieee_div(dist, float(f32(max(radius, 1e-6)))), 0.0, 1.0)
    hard_t = f32(np.clip(brush.properties.hardness * 0.9 + 0.1, 0.0, 1.0))
    s = ieee_div(t - float(hard_t), float(f32(1.0) - hard_t + f32(1e-6)))
    geom = torch.where(t < float(hard_t), 1.0, 1.0 - s * s * (3.0 - 2.0 * s))
    ok = (dist <= radius) & (geom >= 0.01)
    sel = selected(selection, min_y, max_y + 1, min_x, max_x + 1, dev)
    if sel is not None:
        ok &= sel

    # the ring's samples: host indices, device gather; the sums of u8
    # values are integers below 2^24, exact in f32 in any order
    idx = resident(_ring_indices(min_x, max_x, min_y, max_y, w, h, sample_radius,
                                 num_samples), dev).long()
    valid = idx >= 0
    flat = source.reshape(-1, 4)[:, 0:3]
    samples = flat[torch.clamp(idx, min=0)].float() * valid[..., None]
    sum_rgb = samples.sum(dim=0)
    count = valid.sum(dim=0).float()

    ok &= count >= 1.0
    window = preview[min_y:max_y + 1, min_x:max_x + 1]
    old_alpha = ieee_div(window[..., 3].float(), 255.0)
    write = ok & (geom >= old_alpha)

    mean = (sum_rgb / torch.clamp(count, min=1.0)[..., None]).to(torch.uint8)  # trunc cast
    rgb = torch.where(write[..., None], mean, window[..., 0:3])
    alpha = torch.where(write, (geom * 255.0).to(torch.uint8), window[..., 3])
    window.copy_(torch.cat([rgb, alpha[..., None]], dim=-1))


def _dense_steps(start, end):
    dx = end[0] - start[0]
    dy = end[1] - start[1]
    distance = float(np.sqrt(dx * dx + dy * dy))
    if distance < 0.1:
        return [start]
    steps = int(np.ceil(distance))
    return [
        (start[0] + dx * i / steps, start[1] + dy * i / steps)
        for i in range(steps + 1)
    ]


def _line_points(start, end, w, h):
    """The reference's stepping discipline (clone_heal.rs:101-132, 262-292):
    a tap (< 0.1 px) stamps UNCONDITIONALLY (bbox clipping handles
    off-canvas centers); line steps skip centers outside the canvas."""
    pts = _dense_steps(start, end)
    if len(pts) == 1:
        return pts
    return [p for p in pts
            if 0.0 <= p[0] and int(p[0]) < w and 0.0 <= p[1] and int(p[1]) < h]


def clone_stamp_line(brush: Brush, preview: torch.Tensor, source: torch.Tensor,
                     start, end, offset, selection=None):
    """Dense 1-px stepping along the stroke segment (clone_heal.rs:101-132)."""
    h, w = source.shape[:2]
    selection = resident(selection, preview.device)
    for p in _line_points(start, end, w, h):
        clone_stamp_circle(brush, preview, source, p, offset, selection)


def heal_line(brush: Brush, preview: torch.Tensor, source: torch.Tensor,
              start, end, sample_radius: float, selection=None):
    """Dense stepping for the healing stroke (clone_heal.rs:262-292)."""
    h, w = source.shape[:2]
    selection = resident(selection, preview.device)
    for p in _line_points(start, end, w, h):
        heal_circle(brush, preview, source, p, sample_radius, selection)
