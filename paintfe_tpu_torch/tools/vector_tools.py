"""Vector-ish interactive tools: Bézier line, lasso, perspective crop
(paintfe_tpu.tools.vector_tools counterpart).

Behavioral contract: src/ui/panels/tools/behavior/raster/ —
- bezier_math.rs: cubic curve sampled at spacing = max(size*0.1, 0.5),
  steps clamped to 20..5000 (:76-200); dots are max-alpha circle stamps at
  forced hardness 0.95 with `compute_line_alpha` (brush_render.rs:85-132);
  dotted/dashed patterns gate on cumulative arc length (:149-190); arrow
  heads are AA triangles aligned to the curve tangents (:200-287); flat caps
  skip the endpoint dots (:205-210).
- perspective_gradient.rs: lasso = even-odd scanline polygon fill at row
  centers merged by SelectionMode (:2-92); perspective crop inverse-maps the
  output box through the bilinear quad [TL,TR,BR,BL] and resamples every
  layer (:94-186) with round-half-away bilinear lerp (:186-243).

Where the work runs: the Bézier's dots and arrowheads stamp into a u8
[H, W, 4] tensor on its device, and the perspective crop's corner map and
gathers run on `device` (each lerp rounds to u8, so it is a plain gather,
not a bilinear warp).  The curve's points, the dash gating and the lasso's
scanlines (Python floats, f64) stay on the host, as in the JAX package,
and the selection stays a host array.
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.tools.stamp import check_target, resident, selected
from paintfe_tpu_torch.utils.device import resolve_device
from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32


def bezier_point(p0, p1, p2, p3, t):
    """Cubic Bézier (bezier_math.rs:27-39)."""
    u = 1.0 - t
    x = (u ** 3) * p0[0] + 3 * (u ** 2) * t * p1[0] + 3 * u * (t ** 2) * p2[0] + (t ** 3) * p3[0]
    y = (u ** 3) * p0[1] + 3 * (u ** 2) * t * p1[1] + 3 * u * (t ** 2) * p2[1] + (t ** 3) * p3[1]
    return (x, y)


def compute_line_alpha(dist, radius, hardness, anti_alias):
    """Line-stamp falloff (brush_render.rs:85-132) of the f32 tensor `dist`,
    where it lies."""
    if not anti_alias:
        return (dist < radius).float()
    hs = min(max(hardness, 0.0), 0.99)
    if radius < 1.5:
        eff, fade = radius + 1.0, 1.0
    elif radius < 3.0:
        eff = radius + 1.5
        fade = 1.5 + radius * (1.0 - hs)
    else:
        eff = radius
        fade = max(radius * (1.0 - hs), 2.0)
    solid = float(f32(eff - fade))
    t = ieee_div(dist - solid, float(f32(fade)))
    x = 1.0 - torch.clamp(t, 0.0, 1.0)
    alpha = x * x * (3.0 - 2.0 * x)
    return torch.where(dist <= solid, 1.0, torch.where(dist >= eff, 0.0, alpha))


def _write_max_alpha(window, ok, alpha, color):
    """Where `ok` and `alpha` exceeds the window's alpha: the colour, with
    alpha * 255 truncated (bezier_math.rs:500-527)."""
    base_a = ieee_div(window[..., 3].float(), 255.0)
    write = ok & (alpha > base_a)
    out = [torch.where(write, int(np.uint8(color[k])), window[..., k]) for k in range(3)]
    out.append(torch.where(write, (alpha * 255.0).to(torch.uint8), window[..., 3]))
    window.copy_(torch.stack(out, dim=-1))


def _stamp_circle(preview, pos, color, radius, hardness, anti_alias, selection):
    """Max-alpha circle stamp (bezier_math.rs:456-527)."""
    h, w = preview.shape[:2]
    dev = preview.device
    cx, cy = pos
    if anti_alias:
        pad = 1.5 if radius < 1.5 else max(radius * (1.0 - hardness), 2.0) + 2.0
    else:
        pad = 1.0
    outer = radius + pad
    min_x = int(max(cx - outer, 0.0))
    max_x = min(int(np.ceil(cx + outer)), w - 1)
    min_y = int(max(cy - outer, 0.0))
    max_y = min(int(np.ceil(cy + outer)), h - 1)
    if max_x < min_x or max_y < min_y:
        return
    gx = torch.arange(min_x, max_x + 1, dtype=torch.float32, device=dev) - float(f32(cx))
    gy = torch.arange(min_y, max_y + 1, dtype=torch.float32, device=dev) - float(f32(cy))
    dist = sqrt_f32((gx * gx)[None, :] + (gy * gy)[:, None])
    alpha = compute_line_alpha(dist, radius, hardness, anti_alias) * float(f32(color[3] / 255.0))
    ok = alpha > 0.0
    sel = selected(selection, min_y, max_y + 1, min_x, max_x + 1, dev)
    if sel is not None:
        ok &= sel
    window = preview[min_y:max_y + 1, min_x:max_x + 1]
    _write_max_alpha(window, ok, alpha, color)


def draw_filled_triangle(preview, a, b, c, color, selection=None):
    """AA triangle for arrowheads: signed edge distances, 1px smoothstep fade,
    max-alpha write (bezier_math.rs:289-374)."""
    check_target(preview)
    h, w = preview.shape[:2]
    dev = preview.device
    fade = 1.0
    min_x = int(max(np.floor(min(a[0], b[0], c[0]) - fade), 0.0))
    max_x = min(int(np.ceil(max(a[0], b[0], c[0]) + fade)), w - 1)
    min_y = int(max(np.floor(min(a[1], b[1], c[1]) - fade), 0.0))
    max_y = min(int(np.ceil(max(a[1], b[1], c[1]) + fade)), h - 1)
    if max_x < min_x or max_y < min_y:
        return
    px = (torch.arange(min_x, max_x + 1, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(min_y, max_y + 1, dtype=torch.float32, device=dev) + 0.5)[:, None]

    def edge(v0, v1):
        # the JAX package's Python-float scalars enter its f32 arrays as f32
        ex, ey = v1[0] - v0[0], v1[1] - v0[1]
        ln = max(np.sqrt(ex * ex + ey * ey), 0.001)
        return ieee_div((py - v0[1]) * float(f32(ex)) - (px - v0[0]) * float(f32(ey)),
                        float(f32(ln)))

    cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
    sign = 1.0 if cross >= 0.0 else -1.0
    min_d = torch.minimum(torch.minimum(edge(a, b), edge(b, c)), edge(c, a)) * sign
    t = torch.clamp(ieee_div(min_d + fade, 2.0 * fade), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    src_a = float(f32(color[3] / 255.0))
    alpha = torch.where(min_d >= fade, src_a, smooth * src_a)
    ok = (min_d >= -fade) & (alpha > 0.0)
    sel = selected(selection, min_y, max_y + 1, min_x, max_x + 1, dev)
    if sel is not None:
        ok &= sel
    window = preview[min_y:max_y + 1, min_x:max_x + 1]
    _write_max_alpha(window, ok, alpha, color)


def rasterize_bezier(preview, control_points, color, size, *,
                     pattern: str = "solid", cap_style: str = "round",
                     anti_alias: bool = True, selection=None,
                     arrow_side: str = "none"):
    """Stamp a cubic Bézier stroke into `preview` (a u8 [H, W, 4] tensor,
    in place on its device) (bezier_math.rs:76-287).

    `control_points` = [P0, P1, P2, P3]; `pattern` solid|dotted|dashed;
    `cap_style` round|flat; `arrow_side` none|start|end|both.  The points
    are gated by the selection (a host array) on the host; the stamps read
    its upload."""
    check_target(preview)
    h, w = preview.shape[:2]
    dev_sel = resident(selection, preview.device)
    p0, p1, p2, p3 = [tuple(map(float, p)) for p in control_points]
    radius = size / 2.0
    spacing = max(size * 0.1, 0.5)
    chord = np.hypot(p3[0] - p0[0], p3[1] - p0[1])
    net = (np.hypot(p1[0] - p0[0], p1[1] - p0[1])
           + np.hypot(p2[0] - p1[0], p2[1] - p1[1])
           + np.hypot(p3[0] - p2[0], p3[1] - p2[1]))
    steps = int(np.clip(np.ceil((chord + net) / spacing), 20, 5000))

    on_len, off_len = {
        "solid": (0.0, 0.0),
        "dotted": (size * 0.5, size * 1.5),
        "dashed": (size * 2.0, size * 1.5),
    }[pattern]
    cycle = on_len + off_len

    cumulative = 0.0
    last = None
    points = []
    for i in range(steps + 1):
        pos = bezier_point(p0, p1, p2, p3, i / steps)
        if last is not None:
            cumulative += np.hypot(pos[0] - last[0], pos[1] - last[1])
        last = pos
        if not (0.0 <= pos[0] and int(pos[0]) < w and 0.0 <= pos[1] and int(pos[1]) < h):
            continue
        if pattern != "solid" and (cumulative % cycle) >= on_len:
            continue
        if selection is not None and selection[int(pos[1]), int(pos[0])] == 0:
            continue
        points.append((pos, i == 0, i == steps))

    for pos, is_start, is_end in points:
        if cap_style == "flat" and (is_start or is_end):
            continue
        _stamp_circle(preview, pos, color, radius, 0.95, anti_alias, dev_sel)

    if arrow_side in ("start", "end", "both"):
        arrow_len = max(size * 3.0, 8.0)
        half_w = max(size * 1.5, 4.0)
        tip_adv = size + size / 2.0

        def arrow(anchor, ctrl):
            # Outward direction = AWAY from the curve's interior control
            # point: d = -normalize(3*(ctrl - anchor)).  Matches both
            # bezier_math.rs blocks — end: tip = P3 + t(1)*adv; start:
            # tip = P0 - t(0)*adv (the apex trails BEHIND the endpoint,
            # base toward the curve).
            tx, ty = 3.0 * (ctrl[0] - anchor[0]), 3.0 * (ctrl[1] - anchor[1])
            ln = max(np.hypot(tx, ty), 0.001)
            dx, dy = -tx / ln, -ty / ln
            tip = (anchor[0] + dx * tip_adv, anchor[1] + dy * tip_adv)
            base = (tip[0] - dx * arrow_len, tip[1] - dy * arrow_len)
            pxn, pyn = -dy, dx
            w1 = (base[0] + pxn * half_w, base[1] + pyn * half_w)
            w2 = (base[0] - pxn * half_w, base[1] - pyn * half_w)
            draw_filled_triangle(preview, tip, w1, w2, color, dev_sel)

        if arrow_side in ("end", "both"):
            arrow(p3, p2)  # tangent 3(P3-P2), apex past P3
        if arrow_side in ("start", "both"):
            arrow(p0, p1)  # tangent 3(P1-P0), apex behind P0


# ---------------------------------------------------------------------------
# Lasso selection (perspective_gradient.rs:2-92): host scanlines
# ---------------------------------------------------------------------------


def lasso_mask(points, width: int, height: int) -> np.ndarray:
    """Scanline polygon fill at row centers -> u8 {0, 255} mask."""
    mask = np.zeros((height, width), np.uint8)
    pts = [tuple(map(float, p)) for p in points]
    n = len(pts)
    if n < 3:
        return mask
    for y in range(height):
        yf = y + 0.5
        nodes = []
        for i in range(n):
            xi, yi = pts[i]
            xj, yj = pts[(i + 1) % n]
            if (yi < yf <= yj) or (yj < yf <= yi):
                t = (yf - yi) / (yj - yi)
                nodes.append(xi + t * (xj - xi))
        nodes.sort()
        for k in range(0, len(nodes) - 1, 2):
            x_start = min(max(int(nodes[k]) if nodes[k] > 0 else 0, 0), width)
            x_end = min(max(int(nodes[k + 1] + 1.0) if nodes[k + 1] + 1.0 > 0 else 0, 0), width)
            mask[y, x_start:x_end] = 255
    return mask


def apply_lasso_selection(canvas, points, mode):
    """Merge the lasso polygon into the canvas selection
    (perspective_gradient.rs:40-89)."""
    from paintfe_tpu_torch.core.selection import SelectionMode

    mode = SelectionMode(getattr(mode, "value", mode))
    new = lasso_mask(points, canvas.width, canvas.height)
    existing = canvas.selection
    if mode == SelectionMode.REPLACE or existing is None and mode == SelectionMode.ADD:
        canvas.selection = new
    elif mode == SelectionMode.ADD:
        canvas.selection = np.where(new > 0, np.uint8(255), existing)
    elif mode == SelectionMode.SUBTRACT:
        if existing is not None:
            canvas.selection = np.where(new > 0, np.uint8(0), existing)
    elif mode == SelectionMode.INTERSECT:
        if existing is not None:
            keep = (new > 0) & (existing > 0)
            canvas.selection = np.where(keep, np.minimum(new, existing), np.uint8(0))
        else:
            canvas.selection = None


# ---------------------------------------------------------------------------
# Perspective crop (perspective_gradient.rs:94-243)
# ---------------------------------------------------------------------------


def _bilinear_sample_rha(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """Round-half-away bilinear gather matching the per-channel u8 lerps:
    img u8 [H, W, C] on the device of the f32 maps sx, sy [h, w]."""
    h, w = img.shape[:2]
    fsx, fsy = torch.floor(sx), torch.floor(sy)
    x0 = torch.clamp(fsx.long(), 0, w - 1)
    y0 = torch.clamp(fsy.long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (sx - fsx)[..., None]
    fy = (sy - fsy)[..., None]
    p00 = img[y0, x0].float()
    p10 = img[y0, x1].float()
    p01 = img[y1, x0].float()
    p11 = img[y1, x1].float()

    def lerp_u8(a, b, t):  # each lerp rounds to u8 before the next (rs:214-218)
        return torch.clamp(torch.floor(a * (1.0 - t) + b * t + 0.5), 0.0, 255.0)

    top = lerp_u8(p00, p10, fx)
    bot = lerp_u8(p01, p11, fx)
    return lerp_u8(top, bot, fy).to(torch.uint8)


def apply_perspective_crop(canvas, corners, device="cuda"):
    """Resample every layer through the bilinear quad [TL, TR, BR, BL] and
    crop the canvas to the quad's bounding box (perspective_gradient.rs:94-186).
    Text layers are rasterized first; the selection is cleared.  The corner
    map and each layer's gather run on `device`; the layers stay host
    arrays."""
    from paintfe_tpu_torch.core.canvas import upload

    dev = resolve_device(device)
    cs = [tuple(map(float, c)) for c in corners]
    min_x = max(min(c[0] for c in cs), 0.0)
    min_y = max(min(c[1] for c in cs), 0.0)
    max_x = min(max(c[0] for c in cs), float(canvas.width))
    max_y = min(max(c[1] for c in cs), float(canvas.height))
    out_w = int(np.floor((max_x - min_x) + 0.5))
    out_h = int(np.floor((max_y - min_y) + 0.5))
    if out_w < 2 or out_h < 2:
        return False

    # dirty text layers must rasterize BEFORE the warp — flipping content
    # to raster below would otherwise warp stale/blank pixels
    # (perspective_gradient.rs:134-141)
    from paintfe_tpu_torch.ops.text_layer import ensure_text_layers_rasterized

    ensure_text_layers_rasterized(canvas, device=dev)

    u = ieee_div(torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5,
                 float(out_w))[None, :]
    v = ieee_div(torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5,
                 float(out_h))[:, None]
    tl, tr, br, bl = cs
    iu, iv = 1.0 - u, 1.0 - v
    sx = iu * iv * tl[0] + u * iv * tr[0] + u * v * br[0] + iu * v * bl[0]
    sy = iu * iv * tl[1] + u * iv * tr[1] + u * v * br[1] + iu * v * bl[1]

    for layer in canvas.layers:
        if layer.content == "text":
            layer.content = "raster"
        layer.pixels = _bilinear_sample_rha(upload(layer.pixels, dev), sx, sy).cpu().numpy()
        if layer.mask is not None:
            m = _bilinear_sample_rha(upload(layer.mask, dev)[..., None], sx, sy)
            layer.mask = m[..., 0].cpu().numpy()
    canvas.width = out_w
    canvas.height = out_h
    canvas.selection = None
    return True
