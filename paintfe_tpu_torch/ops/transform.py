"""Flips and rotations, exact permutations of u8 [..., H, W, 4] images,
the image-crate resize, the canvas resize, the displacement warp and the
affine transform (paintfe_tpu.ops.transform's flips, rotations, resize,
resize_canvas, warp_displacement, apply_affine and rotate_arbitrary).

The permutations work on numpy arrays (the script host's pixel buffer) and
on torch tensors of any leading batch shape (the batch pipeline).  Resize
and resize_canvas are host numpy in the JAX package and are copied here as
host numpy, so they come out identical to it.  The affine transform takes
its coefficients on the host (numpy f32, as the JAX package) and maps and
gathers on a torch device: K-warp for bilinear, a plain gather for
nearest.  The Liquify brushes touch a brush-sized window of a host field:
they are host numpy with the JAX package's numpy calls (its f32 `np.exp`
included), so both packages give the same bytes on one host.  The mesh
warp evaluates its Catmull-Rom surfaces on the device in the JAX package's
f32 order, one torch op a product or sum (nothing contracts into an FMA),
and gathers through `warp_displacement` (K-warp, mode "zero").
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.utils.quant import ieee_div, round_half_away

f32 = np.float32


def _flip(img, axes):
    if isinstance(img, torch.Tensor):
        return torch.flip(img, dims=[a - 3 for a in axes])
    img = np.asarray(img)
    return np.ascontiguousarray(np.flip(img, axis=[img.ndim + a - 3 for a in axes]))


def flip_horizontal(img):
    return _flip(img, (1,))


def flip_vertical(img):
    return _flip(img, (0,))


def rotate_180(img):
    return _flip(img, (0, 1))


def rotate_90cw(img):
    if isinstance(img, torch.Tensor):
        return torch.rot90(img, k=-1, dims=(-3, -2)).contiguous()
    return np.ascontiguousarray(np.rot90(np.asarray(img), k=-1, axes=(-3, -2)))


def rotate_90ccw(img):
    if isinstance(img, torch.Tensor):
        return torch.rot90(img, k=1, dims=(-3, -2)).contiguous()
    return np.ascontiguousarray(np.rot90(np.asarray(img), k=1, axes=(-3, -2)))


def warp_displacement(src, field, device="cuda") -> torch.Tensor:
    """Full-image displacement warp (transform.rs:1288-1345): output(x, y)
    = bilinear src(x - dx, y - dy), zero-padded corners, transparent
    outside the source.  src: u8 [Hs, Ws, 4] or [B, Hs, Ws, 4] (a tensor,
    run where it is, or numpy, moved to `device`, the card unless the
    caller passes "cpu"); field: (dx, dy) f32 [H, W, 2] (torch or numpy) or
    a DisplacementField.  The gather is K-warp in mode "zero" on the card,
    its plain version on the CPU."""
    from paintfe_tpu_torch.ops.common import as_image, coord_grids
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    src = as_image(src, device)
    if isinstance(field, DisplacementField):
        field = field.data
    if not isinstance(field, torch.Tensor):
        # round to f32 first: sx/sy arithmetic never runs in f64
        field = torch.from_numpy(np.asarray(field, np.float32))
    disp = field.to(device=src.device, dtype=torch.float32)
    h, w = disp.shape[:2]
    xs, ys = coord_grids(h, w, src.device)
    sx = xs - disp[..., 0]
    sy = ys - disp[..., 1]
    return gather_bilinear_u8(src, sx, sy, mode="zero")


# ---------------------------------------------------------------------------
# image-crate-compatible separable resize
# ---------------------------------------------------------------------------


def _box_kernel(x):
    return np.ones_like(x)


def _triangle_kernel(x):
    a = np.abs(x)
    return np.where(a < 1.0, f32(1.0) - a, f32(0.0))


def _catmullrom_kernel(x):
    # cubic BC with b=0, c=0.5 (image crate's CatmullRom)
    a = np.abs(x).astype(f32)
    b, c = f32(0.0), f32(0.5)
    k1 = (f32(12.0) - f32(9.0) * b - f32(6.0) * c) * a**3 + (
        f32(-18.0) + f32(12.0) * b + f32(6.0) * c
    ) * a**2 + (f32(6.0) - f32(2.0) * b)
    k2 = (-b - f32(6.0) * c) * a**3 + (f32(6.0) * b + f32(30.0) * c) * a**2 + (
        f32(-12.0) * b - f32(48.0) * c
    ) * a + (f32(8.0) * b + f32(24.0) * c)
    k = np.where(a < 1.0, k1, np.where(a < 2.0, k2, f32(0.0)))
    return (k / f32(6.0)).astype(f32)


def _sinc(t):
    t = t.astype(f32)
    a = t * f32(np.pi)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.sin(a, dtype=f32) / a
    return np.where(t == 0.0, f32(1.0), v).astype(f32)


def _lanczos3_kernel(x):
    a = np.abs(x).astype(f32)
    return np.where(a < 3.0, _sinc(x) * _sinc(x / f32(3.0)), f32(0.0)).astype(f32)


_FILTERS = {
    "nearest": (_box_kernel, 0.0),
    "bilinear": (_triangle_kernel, 1.0),
    "bicubic": (_catmullrom_kernel, 2.0),
    "lanczos3": (_lanczos3_kernel, 3.0),
}


def _sample_axis(data: np.ndarray, new_len: int, kernel, support: float) -> np.ndarray:
    """One resampling pass along axis 0 (f32 in, f32 out), mirroring the
    image crate's vertical_sample loop structure."""
    old_len = data.shape[0]
    ratio = f32(old_len) / f32(new_len)
    sratio = ratio if ratio >= 1.0 else f32(1.0)
    src_support = f32(support) * sratio

    out = np.zeros((new_len,) + data.shape[1:], f32)
    for o in range(new_len):
        inputx = (f32(o) + f32(0.5)) * ratio
        left = int(np.floor(f32(inputx - src_support)))
        left = min(max(left, 0), old_len - 1)
        right = int(np.ceil(f32(inputx + src_support)))
        right = min(max(right, left + 1), old_len)
        center = f32(inputx - f32(0.5))
        idx = np.arange(left, right)
        ws = kernel(((idx.astype(f32) - center) / sratio).astype(f32)).astype(f32)
        total = f32(0.0)
        for wv in ws:  # sequential f32 sum, matching the Rust loop
            total = f32(total + wv)
        ws = (ws / total).astype(f32)
        # accumulate in tap order (f32)
        acc = np.zeros(data.shape[1:], f32)
        for k, i in enumerate(idx):
            acc += data[i] * ws[k]
        out[o] = acc
    return out


def resize(img, new_w: int, new_h: int, interpolation: str = "bilinear") -> np.ndarray:
    """image::imageops::resize parity: vertical pass, then horizontal, f32
    intermediate, clamp + round-half-away to u8 at the end."""
    img = np.asarray(img)
    kernel, support = _FILTERS[interpolation]
    data = img.astype(f32)
    tmp = _sample_axis(data, new_h, kernel, support)  # vertical
    out = _sample_axis(np.swapaxes(tmp, 0, 1), new_w, kernel, support)
    out = np.swapaxes(out, 0, 1)
    return np.clip(np.floor(out + f32(0.5)), 0, 255).astype(np.uint8)


def resize_canvas(img, new_w: int, new_h: int, anchor=(0, 0), fill=(0, 0, 0, 0)):
    """Anchor-offset copy onto fill color (transform.rs:382-464).
    anchor components: 0=start, 1=center, 2=end."""
    img = np.asarray(img)
    old_h, old_w = img.shape[:2]
    ax, ay = anchor
    # Rust i32 division truncates toward zero; Python // floors — match Rust.
    offset_x = (0 if ax == 0
                else int((new_w - old_w) / 2) if ax == 1 else new_w - old_w)
    offset_y = (0 if ay == 0
                else int((new_h - old_h) / 2) if ay == 1 else new_h - old_h)
    out = np.empty((new_h, new_w, 4), np.uint8)
    out[...] = np.asarray(fill, np.uint8)
    sx0 = max(-offset_x, 0)
    sy0 = max(-offset_y, 0)
    dx0 = max(offset_x, 0)
    dy0 = max(offset_y, 0)
    cw = min(old_w - sx0, new_w - dx0)
    ch = min(old_h - sy0, new_h - dy0)
    if cw > 0 and ch > 0:
        out[dy0 : dy0 + ch, dx0 : dx0 + cw] = img[sy0 : sy0 + ch, sx0 : sx0 + cw]
    return out


# ---------------------------------------------------------------------------
# Affine / perspective transform
# ---------------------------------------------------------------------------

# coordinates beyond +-2^24 lie outside any source; they are clamped there
# so that K-warp's float-to-int conversion and torch's agree
_COORD_LIMIT = float(1 << 24)


def _invert_3x3(m):
    a, b, c = m[0]
    d, e, fv = m[1]
    g, h, i = m[2]
    det = a * (e * i - fv * h) - b * (d * i - fv * g) + c * (d * h - e * g)
    if abs(det) < 1e-12:
        return np.eye(3, dtype=f32)
    inv = f32(1.0) / det
    return np.array(
        [
            [(e * i - fv * h) * inv, (c * h - b * i) * inv, (b * fv - c * e) * inv],
            [(fv * g - d * i) * inv, (a * i - c * g) * inv, (c * d - a * fv) * inv],
            [(d * h - e * g) * inv, (b * g - a * h) * inv, (a * e - b * d) * inv],
        ],
        f32,
    )


def _affine_params(rotation_z, rotation_x, rotation_y, scale, offset_x,
                   offset_y, canvas_w, canvas_h) -> np.ndarray:
    """Host-side f32 homography coefficients -> f32[12] parameter vector
    [h00..h22, offset_x, offset_y, inv_scale], in the Rust f32 sequence
    (numpy's f32 sin and cos of the angles, as the JAX package takes
    them)."""
    inv_scale = f32(1.0) / f32(scale) if abs(scale) > 1e-6 else f32(1.0)
    focal = f32(max(canvas_w, canvas_h)) * f32(1.5)

    def rad(d):
        return f32(f32(d) * (f32(np.pi) / f32(180.0)))

    sz, cz = f32(np.sin(rad(rotation_z))), f32(np.cos(rad(rotation_z)))
    sxr, cxr = f32(np.sin(rad(rotation_x))), f32(np.cos(rad(rotation_x)))
    syr, cyr = f32(np.sin(rad(rotation_y))), f32(np.cos(rad(rotation_y)))

    r00 = cz * cyr
    r01 = cz * syr * sxr - sz * cxr
    r10 = sz * cyr
    r11 = sz * syr * sxr + cz * cxr
    r20 = -syr
    r21 = cyr * sxr

    hmat = np.array(
        [[focal * r00, focal * r01, 0.0], [focal * r10, focal * r11, 0.0], [r20, r21, focal]],
        f32,
    )
    hi = _invert_3x3(hmat)
    return np.array([hi[0][0], hi[0][1], hi[0][2],
                     hi[1][0], hi[1][1], hi[1][2],
                     hi[2][0], hi[2][1], hi[2][2],
                     offset_x, offset_y, inv_scale], f32)


def _affine_map(params: np.ndarray, canvas_w: int, canvas_h: int, dev):
    """(src_x, src_y, degenerate) on `dev`: the inverse map of every output
    pixel of a canvas_w x canvas_h canvas, in the JAX package's f32 order
    (h00 * u + (h01 * v + h02), one reciprocal of wq, multiplies; separate
    torch ops, so nothing contracts into an FMA).  A degenerate pixel
    (|wq| < 1e-8) is given a coordinate outside any source; coordinates
    are clamped to +-2^24."""
    from paintfe_tpu_torch.ops.common import coord_grids

    (h00, h01, h02, h10, h11, h12, h20, h21, h22,
     offset_x, offset_y, inv_scale) = torch.from_numpy(params).to(dev).unbind(0)
    cx = torch.tensor(f32(canvas_w) * f32(0.5), device=dev)
    cy = torch.tensor(f32(canvas_h) * f32(0.5), device=dev)
    xs, ys = coord_grids(canvas_h, canvas_w, dev)
    u = (xs[:1] - cx - offset_x) * inv_scale  # [1, W]
    v = (ys[:, :1] - cy - offset_y) * inv_scale  # [H, 1]
    wq = h20 * u + (h21 * v + h22)
    degenerate = torch.abs(wq) < torch.tensor(f32(1e-8), device=dev)
    # 1 / wq as a true divide of two device tensors (a divide by a host
    # scalar would be a multiply by its reciprocal on the card)
    inv_w = torch.ones((), device=dev) / torch.where(degenerate, 1.0, wq)

    def coord(a, b, c, centre):
        t = torch.clamp((a * u + (b * v + c)) * inv_w + centre, -_COORD_LIMIT, _COORD_LIMIT)
        return torch.where(degenerate, -_COORD_LIMIT, t).contiguous()

    return coord(h00, h01, h02, cx), coord(h10, h11, h12, cy), degenerate


def _affine_fn(canvas_w, canvas_h, src_h, src_w, nearest):
    """run(src, params): _affine_map on src's device, then the gather:
    K-warp in mode "zero" for bilinear, a plain gather for nearest (both
    make a degenerate pixel transparent: its coordinate lies outside the
    source)."""

    def run(src: torch.Tensor, params: np.ndarray) -> torch.Tensor:
        from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

        src_x, src_y, _ = _affine_map(params, canvas_w, canvas_h, src.device)
        if not nearest:
            return gather_bilinear_u8(src, src_x, src_y, "zero")
        nx = round_half_away(src_x).to(torch.int32)
        ny = round_half_away(src_y).to(torch.int32)
        inb = (nx >= 0) & (ny >= 0) & (nx < src_w) & (ny < src_h)
        out = src[..., torch.clamp(ny, 0, src_h - 1).long(),
                  torch.clamp(nx, 0, src_w - 1).long(), :]
        return torch.where(inb[..., None], out, 0)

    return run


def apply_affine(img, rotation_z=0.0, rotation_x=0.0, rotation_y=0.0, scale=1.0,
                 offset=(0.0, 0.0), canvas_size=None, interpolation="bilinear",
                 device="cuda") -> torch.Tensor:
    """Inverse-mapped Rz*Ry*Rx homography with focal 1.5*max(w,h) perspective,
    center-anchored; out-of-source samples transparent (transform.rs:826-976).
    Rotation args are in degrees.  img: u8 [Hs, Ws, 4] or a batch
    [B, Hs, Ws, 4] sharing one map (numpy or torch), moved to `device`
    (the card unless the caller passes "cpu"); returns a u8 tensor of the
    output canvas (canvas_size = (w, h), default the source's) there."""
    from paintfe_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img, np.uint8))
    img = img.to(dev)
    src_h, src_w = img.shape[-3], img.shape[-2]
    ch, cw = (src_h, src_w) if canvas_size is None else (canvas_size[1], canvas_size[0])
    params = _affine_params(
        float(rotation_z), float(rotation_x), float(rotation_y), float(scale),
        float(offset[0]), float(offset[1]), cw, ch,
    )
    fn = _affine_fn(cw, ch, src_h, src_w, interpolation == "nearest")
    return fn(img, params)


def rotate_arbitrary(img, degrees: float, interpolation: str = "bilinear", device="cuda"):
    """Whole-canvas rotation, canvas size unchanged (transform.rs:134-186);
    `img` comes back as it is below 0.001 degrees."""
    if abs(degrees) < 0.001:
        return img
    return apply_affine(img, rotation_z=degrees, interpolation=interpolation,
                        device=device)


# ---------------------------------------------------------------------------
# Displacement field (Liquify)
# ---------------------------------------------------------------------------


class DisplacementField:
    """(dx, dy) f32 field on the host; output(x,y) = src(x-dx, y-dy).

    Brush ops mirror transform.rs:1051-1200: host numpy over a
    brush-radius window, the JAX package's calls.  Each returns the
    window it touched, (x0, y0, x1, y1)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.data = np.zeros((height, width, 2), f32)

    def _window(self, center_x, center_y, radius):
        r = f32(max(radius, 1.0))
        x0 = max(int(np.floor(f32(center_x) - r)), 0)
        y0 = max(int(np.floor(f32(center_y) - r)), 0)
        # the ends clamp at the starts: a brush centre off the canvas
        # touches nothing (transform.rs:1063-1081)
        x1 = min(max(int(np.ceil(f32(center_x) + r)), x0), self.width)
        y1 = min(max(int(np.ceil(f32(center_y) + r)), y0), self.height)
        xs = np.arange(x0, x1, dtype=f32) - f32(center_x)
        ys = np.arange(y0, y1, dtype=f32) - f32(center_y)
        dx = xs[None, :] * np.ones((len(ys), 1), f32)
        dy = ys[:, None] * np.ones((1, len(xs)), f32)
        dist_sq = dx * dx + dy * dy
        inside = dist_sq <= r * r
        return (x0, y0, x1, y1), dx, dy, dist_sq, inside, r

    def apply_push(self, center_x, center_y, delta_x, delta_y, radius, strength):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        sigma = r / f32(3.0)
        s2 = f32(2.0) * sigma * sigma
        weight = np.exp(-dist_sq / s2, dtype=f32) * f32(strength)
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += f32(delta_x) * weight
        self.data[y0:y1, x0:x1, 1] += f32(delta_y) * weight
        return (x0, y0, x1, y1)

    def apply_expand(self, center_x, center_y, radius, strength):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        dist = np.maximum(np.sqrt(dist_sq, dtype=f32), f32(0.001))
        t = dist / r
        weight = (f32(1.0) - t) * (f32(1.0) - t) * f32(strength) * f32(3.0)
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += dx / dist * weight
        self.data[y0:y1, x0:x1, 1] += dy / dist * weight
        return (x0, y0, x1, y1)

    def apply_contract(self, center_x, center_y, radius, strength):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        sigma = r / f32(3.0)
        s2 = f32(2.0) * sigma * sigma
        dist = np.maximum(np.sqrt(dist_sq, dtype=f32), f32(0.001))
        weight = np.exp(-dist_sq / s2, dtype=f32) * f32(strength)
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += -dx / dist * weight * f32(2.0)
        self.data[y0:y1, x0:x1, 1] += -dy / dist * weight * f32(2.0)
        return (x0, y0, x1, y1)

    def apply_twirl(self, center_x, center_y, radius, strength, clockwise=True):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        sigma = r / f32(3.0)
        s2 = f32(2.0) * sigma * sigma
        d = f32(1.0) if clockwise else f32(-1.0)
        weight = np.exp(-dist_sq / s2, dtype=f32) * f32(strength) * d
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += -dy * weight * f32(0.1)
        self.data[y0:y1, x0:x1, 1] += dx * weight * f32(0.1)
        return (x0, y0, x1, y1)


# ---------------------------------------------------------------------------
# Catmull-Rom mesh warp
# ---------------------------------------------------------------------------


def catmull_rom_weights(t: torch.Tensor):
    """Cardinal spline weights, tau=0.5 (transform.rs:1557-1567), of an f32
    tensor."""
    t2 = t * t
    t3 = t2 * t
    return (
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    )


def catmull_rom_surface(points, cols, rows, u_global, v_global):
    """Bicubic CR surface over a (rows+1)x(cols+1) control grid; u in
    [0, cols], v in [0, rows] (transform.rs:1586-1646).  `points` is
    [(rows+1)*(cols+1), 2] (numpy or a tensor, moved to u_global's device);
    u_global and v_global are f32 tensors of one shape.  Returns (x, y)."""
    dev = u_global.device
    points = torch.as_tensor(np.asarray(points, f32) if not isinstance(points, torch.Tensor)
                             else points, device=dev).float()
    pts_per_row = cols + 1
    num_rows = rows + 1
    col_f = torch.clamp(u_global, 0.0, float(f32(cols) - f32(0.0001)))
    row_f = torch.clamp(v_global, 0.0, float(f32(rows) - f32(0.0001)))
    ci = torch.clamp(col_f.int(), max=cols - 1)
    ri = torch.clamp(row_f.int(), max=rows - 1)
    u = col_f - ci.float()
    v = row_f - ri.float()
    wu = catmull_rom_weights(u)
    wv = catmull_rom_weights(v)
    cu = [torch.clamp(ci - 1, min=0), ci, torch.clamp(ci + 1, max=pts_per_row - 1),
          torch.clamp(ci + 2, max=pts_per_row - 1)]
    rv = [torch.clamp(ri - 1, min=0), ri, torch.clamp(ri + 1, max=num_rows - 1),
          torch.clamp(ri + 2, max=num_rows - 1)]
    px, py = points[:, 0], points[:, 1]
    out_x = out_y = 0.0
    for j in range(4):
        base = rv[j] * pts_per_row
        row_x = row_y = 0.0
        for k in range(4):
            idx = (base + cu[k]).long()
            row_x = row_x + wu[k] * px[idx]
            row_y = row_y + wu[k] * py[idx]
        out_x = out_x + wv[j] * row_x
        out_y = out_y + wv[j] * row_y
    return out_x, out_y


def generate_displacement_from_mesh(original_points, deformed_points, cols, rows,
                                    out_w, out_h, fast=False, device="cuda") -> torch.Tensor:
    """Displacement = deformed CR surface - original CR surface
    (transform.rs:1670-1741; the fast path assumes an identity original
    grid), f32 [out_h, out_w, 2] on `device`."""
    from paintfe_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cols, rows, out_w, out_h = int(cols), int(rows), int(out_w), int(out_h)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] + 0.5
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] + 0.5
    ones_h = torch.ones((out_h, 1), dtype=torch.float32, device=dev)
    ones_w = torch.ones((1, out_w), dtype=torch.float32, device=dev)
    u = ieee_div(xs, float(out_w)) * float(cols) * ones_h
    v = ieee_div(ys, float(out_h)) * float(rows) * ones_w
    dx_def, dy_def = catmull_rom_surface(deformed_points, cols, rows, u, v)
    if fast:
        ox, oy = xs * ones_h, ys * ones_w
    else:
        ox, oy = catmull_rom_surface(original_points, cols, rows, u, v)
    return torch.stack([dx_def - ox, dy_def - oy], dim=-1)


def warp_mesh_catmull_rom(src, original_points, deformed_points, cols, rows,
                          out_w=None, out_h=None, device="cuda") -> torch.Tensor:
    """Mesh displacement + displacement warp (transform.rs:1743-1761) of u8
    [H, W, 4] (a tensor, or numpy moved to `device`)."""
    from paintfe_tpu_torch.ops.common import as_image

    x = as_image(src, device)
    out_h = x.shape[0] if out_h is None else out_h
    out_w = x.shape[1] if out_w is None else out_w
    disp = generate_displacement_from_mesh(original_points, deformed_points, cols, rows,
                                           out_w, out_h, device=x.device)
    return warp_displacement(x, disp)


def uniform_grid(cols: int, rows: int, w: float, h: float) -> np.ndarray:
    """(rows+1)x(cols+1) control lattice spanning [0,w]x[0,h], row-major."""
    pts = np.zeros(((rows + 1) * (cols + 1), 2), f32)
    for r in range(rows + 1):
        for c in range(cols + 1):
            pts[r * (cols + 1) + c] = [
                f32(c) / f32(cols) * f32(w),
                f32(r) / f32(rows) * f32(h),
            ]
    return pts
