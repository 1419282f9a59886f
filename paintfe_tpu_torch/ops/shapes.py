"""SDF shape rendering (paintfe_tpu.ops.shapes counterpart).

Behavioral contract: src/ops/shapes.rs — 17 shape SDFs (:357-847),
coverage = smoothstep(0.5, -0.5, d) when anti-aliased else hard d<0
(:849-858), outline = outer - inner coverage of inset SDF, "Both" mode
blends primary outline over secondary fill (:1260-1289), rasterize into the
rotated AABB + 2px pad with inverse-rotated local coords and pixel centers
at +0.5 (:1169-1305).

The per-pixel math runs in torch f32 on `device`, one operation at a time
in the JAX package's order, each scalar an f32 value and each divide by a
scalar a true divide.  Host work, as in the JAX package: the bounding box,
the heart's 96 vertices, the SVG path parser and its flattening.  The
polygon and star SDFs take an arctan2 and a cos/sin of each pixel: those
are the JAX package's numpy calls on the host (ROADMAP C2), uploaded, and
the rest of the SDF runs on the device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from paintfe_tpu_torch.tools.stamp import resident
from paintfe_tpu_torch.utils.device import resolve_device
from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32
TAU = f32(2.0 * np.pi)
_F32_MAX = float(np.finfo(np.float32).max)


def _f(v) -> float:
    """A host scalar rounded to f32, as a Python float torch casts back
    exactly."""
    return float(f32(v))


class ShapeKind(enum.Enum):
    ELLIPSE = "ellipse"
    RECTANGLE = "rectangle"
    ROUNDED_RECT = "rounded_rect"
    TRAPEZOID = "trapezoid"
    PARALLELOGRAM = "parallelogram"
    TRIANGLE = "triangle"
    RIGHT_TRIANGLE = "right_triangle"
    PENTAGON = "pentagon"
    HEXAGON = "hexagon"
    OCTAGON = "octagon"
    CROSS = "cross"
    CHECK = "check"
    HEART = "heart"
    DIAMOND = "diamond"
    STAR5 = "star5"
    STAR6 = "star6"
    ARROW = "arrow"


class ShapeFillMode(enum.Enum):
    FILLED = "filled"
    OUTLINE = "outline"
    BOTH = "both"


@dataclasses.dataclass
class PlacedShape:
    cx: float
    cy: float
    hw: float
    hh: float
    rotation: float = 0.0
    kind: ShapeKind = ShapeKind.RECTANGLE
    fill_mode: ShapeFillMode = ShapeFillMode.BOTH
    outline_width: float = 3.0
    primary_color: Tuple[int, int, int, int] = (255, 80, 80, 255)
    secondary_color: Tuple[int, int, int, int] = (80, 80, 255, 255)
    anti_alias: bool = True
    corner_radius: float = 0.0
    custom_shape_data: Optional["CustomShapeData"] = None

    @classmethod
    def from_jax(cls, placed) -> "PlacedShape":
        """The port's shape from the JAX package's (enums by value, the
        custom shape's polylines as plain floats)."""
        data = placed.custom_shape_data
        return cls(
            float(placed.cx), float(placed.cy), float(placed.hw), float(placed.hh),
            float(placed.rotation), ShapeKind(getattr(placed.kind, "value", placed.kind)),
            ShapeFillMode(getattr(placed.fill_mode, "value", placed.fill_mode)),
            float(placed.outline_width), tuple(int(c) for c in placed.primary_color),
            tuple(int(c) for c in placed.secondary_color), bool(placed.anti_alias),
            float(placed.corner_radius),
            None if data is None else CustomShapeData.from_jax(data))


# ---------------------------------------------------------------------------
# SDFs (px, py are f32 tensors; hx, hy host scalars)
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _sdf_box(px, py, hx, hy):
    dx = torch.abs(px) - _f(hx)
    dy = torch.abs(py) - _f(hy)
    mx, my = torch.clamp(dx, min=0.0), torch.clamp(dy, min=0.0)
    outside = sqrt_f32(mx * mx + my * my)
    inside = torch.clamp(torch.maximum(dx, dy), max=0.0)
    return outside + inside


def _sdf_rounded_box(px, py, hx, hy, r):
    r = min(r, hx, hy)
    return _sdf_box(px, py, hx - r, hy - r) - _f(r)


def _sdf_ellipse(px, py, rx, ry):
    nx = ieee_div(px, _f(rx))
    ny = ieee_div(py, _f(ry))
    ln = sqrt_f32(nx * nx + ny * ny)
    safe_ln = torch.clamp(ln, min=1e-8)
    scale = sqrt_f32(_f(rx * rx) * ny * ny + _f(ry * ry) * nx * nx) / (
        _f(rx * ry) * safe_ln)
    d = (ln - 1.0) / torch.clamp(scale, min=1e-12)
    return torch.where(ln < 1e-8, _f(-min(rx, ry)), d)


def _sdf_segment(px, py, ax, ay, bx, by):
    dx = f32(bx - ax)
    dy = f32(by - ay)
    t = torch.clamp(ieee_div((px - _f(ax)) * float(dx) + (py - _f(ay)) * float(dy),
                             float(f32(dx * dx + dy * dy))), 0.0, 1.0)
    cx = t * float(dx) + _f(ax)
    cy = t * float(dy) + _f(ay)
    ex, ey = px - cx, py - cy
    return sqrt_f32(ex * ex + ey * ey)


def _sdf_triangle_box(px, py, hx, hy):
    ax, ay = 0.0, -hy
    bx, by = hx, hy
    cx, cy = -hx, hy
    d = torch.minimum(
        _sdf_segment(px, py, ax, ay, bx, by),
        torch.minimum(_sdf_segment(px, py, bx, by, cx, cy), _sdf_segment(px, py, cx, cy, ax, ay)),
    )
    c1 = (py - _f(ay)) * _f(bx - ax) - (px - _f(ax)) * _f(by - ay)
    c2 = (py - _f(by)) * _f(cx - bx) - (px - _f(bx)) * _f(cy - by)
    c3 = (py - _f(cy)) * _f(ax - cx) - (px - _f(cx)) * _f(ay - cy)
    inside = ((c1 >= 0) & (c2 >= 0) & (c3 >= 0)) | ((c1 <= 0) & (c2 <= 0) & (c3 <= 0))
    return torch.where(inside, -d, d)


def _sdf_convex_polygon(verts, px, py):
    n = len(verts)
    d0x, d0y = px - _f(verts[0][0]), py - _f(verts[0][1])
    d = d0x * d0x + d0y * d0y
    s = torch.ones_like(px)
    j = n - 1
    for i in range(n):
        ex = f32(verts[j][0] - verts[i][0])
        ey = f32(verts[j][1] - verts[i][1])
        wx = px - _f(verts[i][0])
        wy = py - _f(verts[i][1])
        t = torch.clamp(ieee_div(wx * float(ex) + wy * float(ey), float(f32(ex * ex + ey * ey))),
                        0.0, 1.0)
        bx = wx - t * float(ex)
        by = wy - t * float(ey)
        d = torch.minimum(d, bx * bx + by * by)
        c1 = py >= _f(verts[i][1])
        c2 = py < _f(verts[j][1])
        c3 = wy * float(ex) > wx * float(ey)
        flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
        s = torch.where(flip, -s, s)
        j = i
    return s * sqrt_f32(d)


def _sdf_polygon(px, py, r, n):
    angle = TAU / f32(n)
    half = angle * f32(0.5)
    # the per-pixel angle and its cosine: host numpy (ROADMAP C2)
    hpx, hpy = _host(px), _host(py)
    theta = np.arctan2(hpy, hpx).astype(f32) + f32(np.pi / 2)
    theta = np.mod(np.mod(theta, angle) + angle, angle) - half
    cos_t = resident(np.cos(theta, dtype=f32), px.device)
    ln = sqrt_f32(px * px + py * py)
    qx = ln * cos_t
    return qx - float(f32(r) * f32(np.cos(half)))


def _sdf_polygon_stretched(px, py, hx, hy, n):
    r = max(min(hx, hy), 0.001)
    sx = f32(r / max(hx, 0.001))
    sy = f32(r / max(hy, 0.001))
    return ieee_div(_sdf_polygon(px * float(sx), py * float(sy), r, n), float(max(sx, sy)))


def _sdf_star(px, py, ro, ri, n):
    angle = f32(np.pi) / f32(n)
    two_a = f32(2.0) * angle
    # the per-pixel angle, its cosine and sine: host numpy (ROADMAP C2)
    hpx, hpy = _host(px), _host(py)
    theta = np.arctan2(hpy, hpx).astype(f32) + f32(np.pi / 2)
    theta = np.mod(np.mod(theta, two_a) + two_a, two_a)
    cos_t = resident(np.cos(theta - angle, dtype=f32), px.device)
    sin_t = resident(np.sin(theta - angle, dtype=f32), px.device)
    ln = sqrt_f32(px * px + py * py)
    cos_a, sin_a = f32(np.cos(angle)), f32(np.sin(angle))
    ax, ay = f32(ro), f32(0.0)
    bx, by = f32(ri) * cos_a, f32(ri) * sin_a
    qx = ln * cos_t
    qy = ln * sin_t
    ex, ey = bx - ax, by - ay
    fx = qx - float(ax)
    fy = qy - float(ay)
    t = torch.clamp(ieee_div(fx * float(ex) + fy * float(ey), float(f32(ex * ex + ey * ey))),
                    0.0, 1.0)
    cx = t * float(ex) + float(ax) - qx
    cy = t * float(ey) + float(ay) - qy
    dist = sqrt_f32(cx * cx + cy * cy)
    cross = fy * float(ex) - fx * float(ey)
    return torch.where(cross < 0, -dist, dist)


def _sdf_diamond(px, py, hx, hy):
    d = ieee_div(torch.abs(px), _f(hx)) + ieee_div(torch.abs(py), _f(hy)) - 1.0
    scale = f32(1.0) / f32(np.sqrt(1.0 / (hx * hx) + 1.0 / (hy * hy)))
    return d * float(scale)


def _sdf_cross(px, py, hx, hy):
    return torch.minimum(
        _sdf_box(px, py, hx * 0.34, hy), _sdf_box(px, py, hx, hy * 0.34)
    )


def _sdf_check(px, py, hx, hy):
    thickness = _f(min(hx, hy) * 0.2)
    d1 = _sdf_segment(px, py, -hx * 0.7, 0.0, -hx * 0.1, hy * 0.6) - thickness
    d2 = _sdf_segment(px, py, -hx * 0.1, hy * 0.6, hx * 0.8, -hy * 0.7) - thickness
    return torch.minimum(d1, d2)


def _sdf_polygon_path(verts, px, py):
    """Scanline inside test + min segment distance (concave-safe)."""
    min_dist = torch.full_like(px, _F32_MAX)
    inside = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    prev = verts[-1]
    eps = np.finfo(np.float32).eps
    for curr in verts:
        min_dist = torch.minimum(min_dist,
                                 _sdf_segment(px, py, prev[0], prev[1], curr[0], curr[1]))
        crosses = (py < _f(curr[1])) != (py < _f(prev[1]))
        edge_dy = f32(prev[1] - curr[1])
        if abs(edge_dy) > eps:
            edge_x = ieee_div((py - _f(curr[1])) * _f(prev[0] - curr[0]),
                              float(edge_dy)) + _f(curr[0])
            inside ^= crosses & (px < edge_x)
        prev = curr
    return torch.where(inside, -min_dist, min_dist)


def _heart_verts(hx, hy):
    ts = np.arange(96, dtype=f32) * TAU / f32(96.0)
    s = np.sin(ts, dtype=f32)
    c = np.cos(ts, dtype=f32)
    xr = f32(16.0) * s * s * s
    yr = (
        f32(13.0) * c
        - f32(5.0) * np.cos(2.0 * ts, dtype=f32)
        - f32(2.0) * np.cos(3.0 * ts, dtype=f32)
        - np.cos(4.0 * ts, dtype=f32)
    )
    sx = f32(hx * 0.98) / np.abs(xr).max() if np.abs(xr).max() > 0 else f32(1.0)
    sy = f32(hy * 0.98) / np.abs(yr).max() if np.abs(yr).max() > 0 else f32(1.0)
    return [(float(x * sx), float(-y * sy)) for x, y in zip(xr, yr)]


def _sdf_heart(px, py, hx, hy):
    verts = _heart_verts(hx, hy)
    return _sdf_polygon_path(verts, px, py + _f(hy * 0.18))


def _sdf_trapezoid(px, py, hx, hy):
    top_hw = hx * 0.55
    return _sdf_convex_polygon(
        [(-top_hw, -hy), (top_hw, -hy), (hx, hy), (-hx, hy)], px, py
    )


def _sdf_parallelogram(px, py, hx, hy):
    skew = hx * 0.3
    return _sdf_convex_polygon(
        [(-hx, -hy), (hx, -hy), (hx + skew, hy), (-hx + skew, hy)], px, py
    )


def _sdf_right_triangle(px, py, hx, hy):
    return _sdf_convex_polygon([(-hx, hy), (hx, hy), (-hx, -hy)], px, py)


def _sdf_arrow(px, py, hx, hy):
    # the scalars are the JAX package's numpy scalar arithmetic, as it is
    shaft_w = f32(hx * 0.55)
    shaft_h = f32(hy * 0.35)
    head_x = f32(hx * 0.05)
    shaft = _sdf_box(
        px - _f((-hx + shaft_w) * 0.5), py, shaft_w * 0.5 + f32(hx) * 0.25, shaft_h
    )
    tx = px - float(head_x)
    tw = f32(hx) - head_x
    max_y = (1.0 - ieee_div(tx, float(tw))) * _f(hy)
    apy = torch.abs(py)
    dy = apy - max_y
    nl = f32(np.sqrt(hy * hy + float(tw) * float(tw)))
    dpx = px - _f(hx)
    dpy = apy
    to_edge = torch.clamp(dpx * float(f32(-hy) / nl) + dpy * float(tw / nl), min=0.0)
    to_tip = sqrt_f32(dpx * dpx + dpy * dpy)
    outside_v = torch.minimum(to_edge, to_tip)
    past_tip = sqrt_f32(dpx * dpx + py * py)
    inside_v = -torch.clamp(torch.minimum(max_y - apy,
                                          ieee_div((float(tw) - tx) * _f(hy), float(nl))),
                            min=0.0)
    head = torch.where(dy > 0.0, outside_v, torch.where(tx > float(tw), past_tip, inside_v))
    return torch.where(px < float(head_x), shaft, head)


def shape_sdf(kind: ShapeKind, px, py, hx, hy, corner_radius=0.0):
    """The signed distance of `kind` at the f32 tensors px, py (local,
    unrotated coordinates), on their device."""
    k = ShapeKind(getattr(kind, "value", kind))
    if k == ShapeKind.RECTANGLE:
        return _sdf_box(px, py, hx, hy)
    if k == ShapeKind.ELLIPSE:
        return _sdf_ellipse(px, py, hx, hy)
    if k == ShapeKind.ROUNDED_RECT:
        return _sdf_rounded_box(px, py, hx, hy, corner_radius)
    if k == ShapeKind.TRIANGLE:
        return _sdf_triangle_box(px, py, hx, hy)
    if k == ShapeKind.RIGHT_TRIANGLE:
        return _sdf_right_triangle(px, py, hx, hy)
    if k == ShapeKind.TRAPEZOID:
        return _sdf_trapezoid(px, py, hx, hy)
    if k == ShapeKind.PARALLELOGRAM:
        return _sdf_parallelogram(px, py, hx, hy)
    if k == ShapeKind.DIAMOND:
        return _sdf_diamond(px, py, hx, hy)
    if k == ShapeKind.PENTAGON:
        return _sdf_polygon_stretched(px, py, hx, hy, 5)
    if k == ShapeKind.HEXAGON:
        return _sdf_polygon_stretched(px, py, hx, hy, 6)
    if k == ShapeKind.OCTAGON:
        return _sdf_polygon_stretched(px, py, hx, hy, 8)
    if k == ShapeKind.CROSS:
        return _sdf_cross(px, py, hx, hy)
    if k == ShapeKind.CHECK:
        return _sdf_check(px, py, hx, hy)
    if k == ShapeKind.STAR5:
        r = min(hx, hy)
        return _sdf_star(px, py, r, r * 0.4, 5)
    if k == ShapeKind.STAR6:
        r = min(hx, hy)
        return _sdf_star(px, py, r, r * 0.5, 6)
    if k == ShapeKind.ARROW:
        return _sdf_arrow(px, py, hx, hy)
    if k == ShapeKind.HEART:
        return _sdf_heart(px, py, hx, hy)
    raise ValueError(f"unknown shape kind {kind}")


def _smoothstep(e0, e1, x):
    t = torch.clamp(ieee_div(x - _f(e0), _f(e1 - e0)), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def coverage_from_sdf(d, anti_alias: bool):
    if anti_alias:
        return _smoothstep(0.5, -0.5, d)
    return torch.where(d < 0.0, 1.0, 0.0)


def _shape_local_corners(kind: ShapeKind, hw, hh):
    if kind == ShapeKind.PARALLELOGRAM:
        skew = hw * 0.3
        return [(-hw, -hh), (hw, -hh), (hw + skew, hh), (-hw + skew, hh)]
    return [(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)]


# ---------------------------------------------------------------------------
# Custom SVG-path shapes (shapes.rs:27-122 parse/flatten, :1065-1160 coverage)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CustomShapeData:
    """A user shape imported from an SVG <path>: the path flattened to
    polylines (tolerance 0.5, like the reference's kurbo::flatten call) plus
    its bounding box.  Rasterization is point-in-polygon (even-odd) with a
    4-point supersample, not an SDF (shapes.rs:1088-1120)."""

    name: str
    category: str
    svg_path_data: str
    polylines: list
    bounds: Tuple[float, float, float, float]

    @classmethod
    def from_jax(cls, data) -> "CustomShapeData":
        return cls(str(data.name), str(data.category), str(data.svg_path_data),
                   [[(float(x), float(y)) for x, y in poly] for poly in data.polylines],
                   tuple(float(v) for v in data.bounds))


class SvgPathError(ValueError):
    pass


def extract_svg_path_data(svg: str) -> str:
    """Pull every <path d="..."> out of an SVG document (shapes.rs:27-58)."""
    if "<image" in svg or "data:image" in svg:
        raise SvgPathError("Embedded raster images are not supported.")
    paths = []
    rest = svg
    while True:
        idx = rest.find("<path")
        if idx < 0:
            break
        rest = rest[idx + 5:]
        end = rest.find(">")
        if end < 0:
            break
        tag = rest[:end]
        for pat in ('d="', "d='"):
            d_idx = tag.find(pat)
            if d_idx >= 0:
                quote = pat[2]
                start = d_idx + len(pat)
                data_end = tag[start:].find(quote)
                if data_end >= 0:
                    d = tag[start:start + data_end].strip()
                    if d:
                        paths.append(d)
        rest = rest[end + 1:]
    if not paths:
        raise SvgPathError('SVG must contain at least one <path d="...">.')
    return " ".join(paths)


def _svg_tokens(d: str):
    """Yield SVG path commands and floats.

    Lexing is command-aware because the SVG grammar makes the arc flags
    (operands 4 and 5 of A/a) single '0'/'1' CHARACTERS that need no
    separator from the following number — minified paths write
    'a1 1 0 011 0' meaning flags 0,1 then x=1 y=0.  A greedy number regex
    would lex '011' as 11.0 and shift every later operand."""
    import re

    num = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
    i = 0
    n = len(d)
    cmd = None
    operand = 0
    while i < n:
        ch = d[i]
        if ch in " \t\r\n,":
            i += 1
            continue
        if ch in "MmLlHhVvCcSsQqTtAaZz":
            cmd = ch
            operand = 0
            i += 1
            yield ch
            continue
        if cmd in ("A", "a") and operand % 7 in (3, 4) and ch in "01":
            yield float(ch)
            operand += 1
            i += 1
            continue
        m = num.match(d, i)
        if m is None:
            i += 1  # skip unrecognized characters (previous behavior)
            continue
        yield float(m.group(0))
        operand += 1
        i = m.end()


def _flatten_cubic(p0, p1, p2, p3, tol, out, depth=0):
    # adaptive subdivision: flat when control points are within tol of the chord
    d1 = abs((p1[0] - p3[0]) * (p3[1] - p0[1]) - (p1[1] - p3[1]) * (p3[0] - p0[0]))
    d2 = abs((p2[0] - p3[0]) * (p3[1] - p0[1]) - (p2[1] - p3[1]) * (p3[0] - p0[0]))
    chord2 = (p3[0] - p0[0]) ** 2 + (p3[1] - p0[1]) ** 2
    if depth >= 16 or (d1 + d2) ** 2 <= 4.0 * tol * tol * max(chord2, 1e-12):
        out.append(p3)
        return
    mid = lambda a, b: ((a[0] + b[0]) * 0.5, (a[1] + b[1]) * 0.5)  # noqa: E731
    p01, p12, p23 = mid(p0, p1), mid(p1, p2), mid(p2, p3)
    p012, p123 = mid(p01, p12), mid(p12, p23)
    c = mid(p012, p123)
    _flatten_cubic(p0, p01, p012, c, tol, out, depth + 1)
    _flatten_cubic(c, p123, p23, p3, tol, out, depth + 1)


def _quad_to_cubic(p0, q, p1):
    return (
        (p0[0] + 2.0 / 3.0 * (q[0] - p0[0]), p0[1] + 2.0 / 3.0 * (q[1] - p0[1])),
        (p1[0] + 2.0 / 3.0 * (q[0] - p1[0]), p1[1] + 2.0 / 3.0 * (q[1] - p1[1])),
    )


def _arc_to_points(p0, rx, ry, xrot, large, sweep, p1, tol, out):
    """Elliptical arc (SVG F.6.5 center parameterization) flattened to lines."""
    import math

    if rx == 0 or ry == 0 or p0 == p1:
        out.append(p1)
        return
    rx, ry = abs(rx), abs(ry)
    phi = math.radians(xrot)
    cphi, sphi = math.cos(phi), math.sin(phi)
    dx2, dy2 = (p0[0] - p1[0]) / 2.0, (p0[1] - p1[1]) / 2.0
    x1p = cphi * dx2 + sphi * dy2
    y1p = -sphi * dx2 + cphi * dy2
    lam = (x1p / rx) ** 2 + (y1p / ry) ** 2
    if lam > 1.0:
        s = math.sqrt(lam)
        rx, ry = rx * s, ry * s
    num = rx * rx * ry * ry - rx * rx * y1p * y1p - ry * ry * x1p * x1p
    den = rx * rx * y1p * y1p + ry * ry * x1p * x1p
    co = math.sqrt(max(num / den, 0.0)) * (1.0 if large != sweep else -1.0)
    cxp, cyp = co * rx * y1p / ry, -co * ry * x1p / rx
    cx = cphi * cxp - sphi * cyp + (p0[0] + p1[0]) / 2.0
    cy = sphi * cxp + cphi * cyp + (p0[1] + p1[1]) / 2.0

    def angle(ux, uy, vx, vy):
        dot = ux * vx + uy * vy
        n = math.sqrt((ux * ux + uy * uy) * (vx * vx + vy * vy))
        a = math.acos(max(-1.0, min(1.0, dot / max(n, 1e-12))))
        return -a if ux * vy - uy * vx < 0 else a

    th1 = angle(1.0, 0.0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dth = angle((x1p - cxp) / rx, (y1p - cyp) / ry, (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2.0 * math.pi
    elif sweep and dth < 0:
        dth += 2.0 * math.pi
    n_seg = max(int(math.ceil(abs(dth) / (math.pi / 16.0))), 1)
    for k in range(1, n_seg + 1):
        th = th1 + dth * k / n_seg
        ex = cx + rx * math.cos(th) * cphi - ry * math.sin(th) * sphi
        ey = cy + rx * math.cos(th) * sphi + ry * math.sin(th) * cphi
        out.append((ex, ey))


def _cubic_bbox_update(bbox, p0, p1, p2, p3):
    """Grow bbox by a cubic's EXACT extent (endpoints + derivative roots),
    matching kurbo's bounding_box computed before flattening."""
    for axis in (0, 1):
        v0, v1, v2, v3 = p0[axis], p1[axis], p2[axis], p3[axis]
        bbox[axis] = min(bbox[axis], v0, v3)
        bbox[axis + 2] = max(bbox[axis + 2], v0, v3)
        # B'(t) = At^2 + Bt + C
        A = 3.0 * (-v0 + 3.0 * v1 - 3.0 * v2 + v3)
        B = 6.0 * (v0 - 2.0 * v1 + v2)
        C = 3.0 * (v1 - v0)
        roots = []
        if abs(A) < 1e-12:
            if abs(B) > 1e-12:
                roots.append(-C / B)
        else:
            disc = B * B - 4.0 * A * C
            if disc >= 0.0:
                sq = disc ** 0.5
                roots.extend(((-B + sq) / (2.0 * A), (-B - sq) / (2.0 * A)))
        for t in roots:
            if 0.0 < t < 1.0:
                mt = 1.0 - t
                v = (mt * mt * mt * v0 + 3.0 * mt * mt * t * v1
                     + 3.0 * mt * t * t * v2 + t * t * t * v3)
                bbox[axis] = min(bbox[axis], v)
                bbox[axis + 2] = max(bbox[axis + 2], v)


def parse_svg_path(d: str, tol: float = 0.5, bbox_out=None):
    """SVG path data -> list of polylines (each a list of (x, y)).

    Supports M/L/H/V/C/S/Q/T/A/Z in absolute and relative form; curves are
    flattened at `tol` like the reference's kurbo::flatten(0.5) call
    (shapes.rs:81).  `bbox_out` (a 4-list [minx, miny, maxx, maxy]) is
    grown with the EXACT curve extents (cubic/quadratic derivative
    extrema) like kurbo's pre-flatten bounding_box — the flattened
    polyline alone undershoots curve bulges by up to `tol`.  Arcs
    contribute their flattened points (they are emitted as samples, not
    cubics, here)."""
    toks = list(_svg_tokens(d))
    polylines = []
    current: list = []
    pos = (0.0, 0.0)
    start = None
    prev_cubic_ctrl = None
    prev_quad_ctrl = None
    i = 0
    cmd = None

    def take(n):
        nonlocal i
        vals = toks[i:i + n]
        if len(vals) != n or any(isinstance(v, str) for v in vals):
            raise SvgPathError(f"malformed path near token {i}")
        i += n
        return vals

    def finish_open():
        nonlocal current
        if len(current) > 1:
            polylines.append(current)
        current = []

    while i < len(toks):
        t = toks[i]
        if isinstance(t, str):
            cmd = t
            i += 1
            if cmd in "Zz":
                if start is not None and current:
                    current.append(start)
                if len(current) > 1:
                    polylines.append(current)
                pos = start if start is not None else pos
                # SVG spec: a drawing command straight after Z starts a
                # new subpath AT THE CLOSEPOINT (which also stays the
                # initial point for a further Z) — kurbo does this; an
                # empty `current` here dropped the first post-Z segment
                current = [pos]
                prev_cubic_ctrl = prev_quad_ctrl = None
                continue
        elif cmd is None:
            raise SvgPathError("path must start with a command")
        rel = cmd.islower()
        c = cmd.upper()
        ox, oy = (pos if rel else (0.0, 0.0))
        if c == "M":
            x, y = take(2)
            finish_open()
            pos = (x + ox, y + oy)
            start = pos
            current = [pos]
            cmd = "l" if rel else "L"  # subsequent pairs are implicit lineto
            prev_cubic_ctrl = prev_quad_ctrl = None
        elif c == "L":
            x, y = take(2)
            pos = (x + ox, y + oy)
            current.append(pos)
            prev_cubic_ctrl = prev_quad_ctrl = None
        elif c == "H":
            (x,) = take(1)
            pos = (x + ox, pos[1])
            current.append(pos)
            prev_cubic_ctrl = prev_quad_ctrl = None
        elif c == "V":
            (y,) = take(1)
            pos = (pos[0], y + oy)
            current.append(pos)
            prev_cubic_ctrl = prev_quad_ctrl = None
        elif c in ("C", "S"):
            if c == "C":
                x1, y1, x2, y2, x, y = take(6)
                p1 = (x1 + ox, y1 + oy)
            else:
                x2, y2, x, y = take(4)
                p1 = (
                    (2 * pos[0] - prev_cubic_ctrl[0], 2 * pos[1] - prev_cubic_ctrl[1])
                    if prev_cubic_ctrl else pos
                )
            p2 = (x2 + ox, y2 + oy)
            p3 = (x + ox, y + oy)
            if bbox_out is not None:
                _cubic_bbox_update(bbox_out, pos, p1, p2, p3)
            _flatten_cubic(pos, p1, p2, p3, tol, current)
            pos = p3
            prev_cubic_ctrl, prev_quad_ctrl = p2, None
        elif c in ("Q", "T"):
            if c == "Q":
                qx, qy, x, y = take(4)
                q = (qx + ox, qy + oy)
            else:
                x, y = take(2)
                q = (
                    (2 * pos[0] - prev_quad_ctrl[0], 2 * pos[1] - prev_quad_ctrl[1])
                    if prev_quad_ctrl else pos
                )
            p3 = (x + ox, y + oy)
            c1, c2 = _quad_to_cubic(pos, q, p3)
            if bbox_out is not None:
                _cubic_bbox_update(bbox_out, pos, c1, c2, p3)
            _flatten_cubic(pos, c1, c2, p3, tol, current)
            pos = p3
            prev_quad_ctrl, prev_cubic_ctrl = q, None
        elif c == "A":
            rx_, ry_, xrot, large, sweep, x, y = take(7)
            p3 = (x + ox, y + oy)
            _arc_to_points(pos, rx_, ry_, xrot, bool(large), bool(sweep), p3, tol, current)
            pos = p3
            prev_cubic_ctrl = prev_quad_ctrl = None
        else:
            raise SvgPathError(f"unsupported path command '{cmd}'")
    finish_open()
    return polylines


def parse_custom_shape(name: str, category: str, svg_path_data: str) -> CustomShapeData:
    """Parse + flatten an SVG path into a drawable custom shape
    (shapes.rs:60-120)."""
    curve_bbox = [float("inf"), float("inf"), float("-inf"), float("-inf")]
    try:
        polylines = parse_svg_path(svg_path_data, bbox_out=curve_bbox)
    except SvgPathError:
        raise
    except Exception as e:  # noqa: BLE001 - surface as the reference's error kind
        raise SvgPathError(f"Invalid SVG path: {e}")
    polylines = [p for p in polylines if len(p) > 1]
    if not polylines:
        raise SvgPathError("SVG path did not produce drawable geometry.")
    # bounds = flattened vertices grown by the EXACT curve extrema, like
    # kurbo's pre-flatten bounding_box (the reference computes the scale
    # mapping from it; flattened-only bounds undershoot curve bulges)
    xs = [x for poly in polylines for x, _ in poly]
    ys = [y for poly in polylines for _, y in poly]
    x0, x1 = min(xs + [curve_bbox[0]]), max(xs + [curve_bbox[2]])
    y0, y1 = min(ys + [curve_bbox[1]]), max(ys + [curve_bbox[3]])
    if not (np.isfinite(x1 - x0) and np.isfinite(y1 - y0)) or x1 - x0 <= 0 or y1 - y0 <= 0:
        raise SvgPathError("SVG path has empty bounds.")
    return CustomShapeData(name, category, svg_path_data, polylines, (x0, y0, x1, y1))


def _segments(polylines, device):
    """Every polyline's consecutive point pairs as f32 [S, 4] on `device`
    (stacked on the host, like the JAX package's)."""
    segs = []
    for poly in polylines:
        p = np.asarray(poly, f32)
        segs.append(np.concatenate([p[:-1], p[1:]], axis=1))
    return torch.from_numpy(np.concatenate(segs, axis=0)).to(device)


# elements of one [rows, W, S] block of the crossing test: the pixels are
# taken a block of rows at a time, each pixel's result its own
_BLOCK = 1 << 22


def _row_blocks(rows: int, cols: int, segs: int):
    step = max(1, _BLOCK // max(cols * segs, 1))
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


def _custom_inside(px, py, segs):
    """Vectorized even-odd crossing test (shapes.rs:1122-1139).
    px/py: [..., 1] broadcast against segs [S, 4]."""
    x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    denom = y2 - y1
    valid = torch.abs(denom) > 1e-6
    straddles = (py < y1) != (py < y2)
    xi = (x2 - x1) * (py - y1) / torch.where(valid, denom, 1.0) + x1
    crossings = (valid & straddles & (px < xi)).sum(dim=-1)
    return (crossings % 2).bool()


def _custom_edge_dist(px, py, segs):
    """Min distance to any segment (shapes.rs:1141-1160)."""
    ax, ay, bx, by = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    dx, dy = bx - ax, by - ay
    len2 = torch.clamp(dx * dx + dy * dy, min=1e-6)
    t = torch.clamp(((px - ax) * dx + (py - ay) * dy) / len2, 0.0, 1.0)
    cx, cy = ax + dx * t, ay + dy * t
    ex, ey = px - cx, py - cy
    return sqrt_f32(ex * ex + ey * ey).amin(dim=-1)


def custom_shape_coverage(data: CustomShapeData, lx, ly, hx, hy,
                          outline_width, fill_mode):
    """4-point supersampled binary coverage in shape-local coords
    (shapes.rs:1065-1120).  lx/ly are [H, W] f32 local coordinates on the
    device the coverage is computed on."""
    segs = _segments(data.polylines, lx.device)
    min_x, min_y, max_x, max_y = data.bounds
    bw = max(max_x - min_x, 1.0)
    bh = max(max_y - min_y, 1.0)
    sx = f32(bw / max(hx * 2.0, 1.0))
    sy = f32(bh / max(hy * 2.0, 1.0))
    mode = ShapeFillMode(getattr(fill_mode, "value", fill_mode))
    total = torch.zeros(lx.shape, dtype=torch.float32, device=lx.device)
    for rows in _row_blocks(lx.shape[0], lx.shape[1], segs.shape[0]):
        blx, bly = lx[rows], ly[rows]
        acc = total[rows]
        for ox, oy in ((-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25)):
            px = ((blx + _f(ox) + _f(hx)) * float(sx) + _f(min_x))[..., None]
            py = ((bly + _f(oy) + _f(hy)) * float(sy) + _f(min_y))[..., None]
            fill = _custom_inside(px, py, segs).float()
            if mode == ShapeFillMode.FILLED:
                acc += fill
                continue
            edge = ieee_div(_custom_edge_dist(px, py, segs), float(max(sx, sy)))
            outline = (edge <= _f(max(outline_width, 1.0))).float()
            acc += outline if mode == ShapeFillMode.OUTLINE else torch.maximum(fill, outline)
    return total * 0.25


def render_custom_shape_icon(shape: CustomShapeData, size: int, dark: bool,
                             device="cuda") -> torch.Tensor:
    """Picker icon: 16x supersampled filled coverage (shapes.rs:122-156),
    u8 [size, size, 4] on `device`."""
    dev = resolve_device(device)
    segs = _segments(shape.polylines, dev)
    min_x, min_y, max_x, max_y = shape.bounds
    bw = max(max_x - min_x, 1.0)
    bh = max(max_y - min_y, 1.0)
    sx, sy = f32(bw / 1.64), f32(bh / 1.64)  # hx=hy=0.82
    fg = 235 if dark else 30
    cov = torch.zeros((size, size), dtype=torch.float32, device=dev)
    base = torch.arange(size, dtype=torch.float32, device=dev)
    for sy_i in range(4):
        for sx_i in range(4):
            lx = ieee_div(base + _f((sx_i + 0.5) * 0.25), float(size)) * 2.0 - 1.0
            ly = ieee_div(base + _f((sy_i + 0.5) * 0.25), float(size)) * 2.0 - 1.0
            px = ((lx + 0.82) * float(sx) + _f(min_x))[None, :, None].expand(size, size, 1)
            py = ((ly + 0.82) * float(sy) + _f(min_y))[:, None, None].expand(size, size, 1)
            cov += _custom_inside(px, py, segs).float()
    cov = torch.clamp(ieee_div(cov, 16.0), 0.0, 1.0)
    hit = cov > 0.0
    rgb = torch.where(hit[..., None], fg, 0).to(torch.uint8).expand(size, size, 3)
    alpha = torch.where(hit, torch.clamp(torch.floor(cov * 255.0 + 0.5), max=255.0), 0.0)
    return torch.cat([rgb, alpha.to(torch.uint8)[..., None]], dim=-1)


def _finish(color, cov):
    """u8 [bh, bw, 4]: rgb of `color` (f32 [..., 4]) and alpha
    floor(a * cov + 0.5) where the coverage is visible, else 0."""
    visible = cov > 0.001
    a = torch.clamp(torch.floor(color[..., 3] * cov + 0.5), max=255.0)
    out = torch.cat([color[..., 0:3].to(torch.uint8).expand(cov.shape + (3,)),
                     a.to(torch.uint8)[..., None]], dim=-1)
    return torch.where(visible[..., None], out, 0)


def rasterize_shape(placed: PlacedShape, canvas_w: int, canvas_h: int, device="cuda"):
    """Returns (buf u8 [bh, bw, 4] tensor on `device`, off_x, off_y)."""
    dev = resolve_device(device)
    cos_r = f32(np.cos(f32(placed.rotation)))
    sin_r = f32(np.sin(f32(placed.rotation)))
    kind = ShapeKind(getattr(placed.kind, "value", placed.kind))
    corners = _shape_local_corners(kind, placed.hw, placed.hh)
    xs = [c[0] * cos_r - c[1] * sin_r + placed.cx for c in corners]
    ys = [c[0] * sin_r + c[1] * cos_r + placed.cy for c in corners]
    pad = 2.0
    x0 = max(int(np.floor(min(xs) - pad)), 0)
    y0 = max(int(np.floor(min(ys) - pad)), 0)
    x1 = min(int(np.ceil(max(xs) + pad)), canvas_w)
    y1 = min(int(np.ceil(max(ys) + pad)), canvas_h)
    bw = max(x1 - x0, 0)
    bh = max(y1 - y0, 0)
    if bw == 0 or bh == 0:
        return torch.zeros((0, 0, 4), dtype=torch.uint8, device=dev), 0, 0

    pxc = (torch.arange(x0, x1, dtype=torch.float32, device=dev) + 0.5)[None, :]
    pyc = (torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5)[:, None]
    dx = (pxc - _f(placed.cx)).expand(bh, bw)
    dy = (pyc - _f(placed.cy)).expand(bh, bw)
    # inverse rotation = transpose
    lx = dx * float(cos_r) - dy * float(-sin_r)
    ly = dx * float(-sin_r) + dy * float(cos_r)

    aa = placed.anti_alias
    primary = torch.tensor(np.asarray(placed.primary_color, f32)).to(dev)
    secondary = torch.tensor(np.asarray(placed.secondary_color, f32)).to(dev)
    ow = max(placed.outline_width, 0.0)
    mode = ShapeFillMode(getattr(placed.fill_mode, "value", placed.fill_mode))

    if placed.custom_shape_data is not None:
        # custom shapes always draw in the primary color (shapes.rs:1241-1249)
        cov = custom_shape_coverage(
            placed.custom_shape_data, lx, ly, placed.hw, placed.hh, ow, mode
        )
        return _finish(primary, cov), x0, y0

    d = shape_sdf(kind, lx, ly, placed.hw, placed.hh, placed.corner_radius)

    if mode == ShapeFillMode.FILLED:
        cov = coverage_from_sdf(d, aa)
        color = primary
    elif mode == ShapeFillMode.OUTLINE:
        cov = torch.clamp(coverage_from_sdf(d, aa) - coverage_from_sdf(d + _f(ow), aa), 0.0, 1.0)
        color = primary
    else:  # BOTH: outline (primary) over fill (secondary)
        fill_cov = coverage_from_sdf(d, aa)
        outline_cov = torch.clamp(fill_cov - coverage_from_sdf(d + _f(ow), aa), 0.0, 1.0)
        oa = outline_cov
        fa = fill_cov * (1.0 - oa)
        total = oa + fa
        safe = torch.clamp(total, min=1e-12)
        mixed = (primary * oa[..., None] + secondary * fa[..., None]) / safe[..., None]
        has_outline = outline_cov > 0.001
        color = torch.where(
            has_outline[..., None],
            mixed.to(torch.uint8).float(),  # truncating as u8
            secondary,
        )
        cov = torch.where(has_outline, torch.where(total > 0.0, total, 0.0), fill_cov)
    return _finish(color, cov), x0, y0


def rasterize_to_canvas(placed: PlacedShape, w: int, h: int, device="cuda") -> torch.Tensor:
    """Composite the rasterized buffer onto a transparent canvas (writes only
    alpha>0 pixels, like the reference test helper)."""
    buf, off_x, off_y = rasterize_shape(placed, w, h, device)
    canvas = torch.zeros((h, w, 4), dtype=torch.uint8, device=buf.device)
    bh, bw = buf.shape[:2]
    if bh and bw:
        region = canvas[off_y: off_y + bh, off_x: off_x + bw]
        write = buf[..., 3] > 0
        region.copy_(torch.where(write[..., None], buf, region))
    return canvas
