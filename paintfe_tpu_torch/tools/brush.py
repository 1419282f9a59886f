"""Brush / pencil / eraser / line stamping engine (paintfe_tpu.tools.brush
counterpart).

Behavioral contract: src/ui/panels/tools/behavior/raster/brush_render.rs —
alpha(dist) = material falloff (1 + (hardness-1)*smoothstep(t)) x geometric
coverage (smoothstep over [radius-0.5, radius+0.5] when AA, hard cutoff
otherwise), precomputed as a 256-entry LUT indexed by squared-distance ratio
(:27-82); max-alpha Normal stamping, preview-mask eraser semantics,
Dodge/Burn/Sponge HSL modes (:330-400); dense per-pixel line stepping
(:762-835).

Stamps are small windows of a u8 [H, W, 4] target tensor, computed and
written in place on the target's device with the reference's exact casts
(truncating LUT index, round-half-away LUT values).  The LUT, the bounding
box, the scatter hash and the jitter colour are host work, as in the JAX
package; the LUT is uploaded once for each device and gathered there.  A
stamp reads nothing back: a stamp that covers no pixel writes nothing.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from paintfe_tpu_torch.tools.stamp import check_target, resident, selected
from paintfe_tpu_torch.utils.quant import ieee_div, sqrt_f32

f32 = np.float32


class BrushMode(enum.Enum):
    NORMAL = "normal"
    DODGE = "dodge"
    BURN = "burn"
    SPONGE = "sponge"


def _smoothstep01(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


@dataclasses.dataclass
class BrushProperties:
    size: float = 10.0
    hardness: float = 1.0
    anti_aliased: bool = True
    flow: float = 1.0
    spacing: float = 0.25
    scatter: float = 0.0
    hue_jitter: float = 0.0
    brightness_jitter: float = 0.0
    brush_mode: BrushMode = BrushMode.NORMAL

    @classmethod
    def from_jax(cls, props) -> "BrushProperties":
        """The port's properties from the JAX package's (the mode by value)."""
        fields = {f.name: getattr(props, f.name) for f in dataclasses.fields(cls)}
        fields["brush_mode"] = BrushMode(getattr(props.brush_mode, "value", props.brush_mode))
        return cls(**fields)


class Brush:
    """Stateful brush (mirrors ToolsPanel's raster behavior surface)."""

    def __init__(self, size=10.0, hardness=1.0, anti_aliased=True, flow=1.0,
                 brush_mode=BrushMode.NORMAL):
        self.properties = BrushProperties(
            size=size, hardness=hardness, anti_aliased=anti_aliased, flow=flow,
            brush_mode=brush_mode,
        )
        self._lut = np.zeros(256, np.uint8)
        self._lut_params = None
        self._lut_on = {}  # device -> the LUT's upload
        self.stamp_counter = 0  # u32, wraps; seeds scatter/jitter hashes
        self.rebuild_brush_lut()

    @classmethod
    def from_jax(cls, brush) -> "Brush":
        """The port's brush in the JAX brush's state: its properties and its
        stamp counter (which seeds the next stamp's scatter and jitter)."""
        out = cls()
        out.properties = BrushProperties.from_jax(brush.properties)
        out.stamp_counter = int(brush.stamp_counter)
        out.rebuild_brush_lut()
        return out

    # -- LUT -------------------------------------------------------------

    def compute_brush_alpha(self, dist: torch.Tensor, radius):
        """Material falloff x geometric coverage (brush_render.rs:53-82) of
        the f32 tensor `dist`, where it lies (on the CPU for the LUT)."""
        if radius <= 0.0:
            return torch.zeros_like(dist)
        hardness = f32(np.clip(self.properties.hardness, 0.0, 1.0))
        t = torch.clamp(ieee_div(dist, float(f32(radius))), 0.0, 1.0)
        material = float(hardness - f32(1.0)) * _smoothstep01(t) + 1.0
        if self.properties.anti_aliased:
            edge0 = f32(radius) + f32(0.5)
            edge1 = f32(radius) - f32(0.5)
            x = torch.clamp(ieee_div(dist - float(edge0), float(edge1 - edge0)), 0.0, 1.0)
            coverage = torch.where(dist <= float(edge1), 1.0,
                                   torch.where(dist >= float(edge0), 0.0, _smoothstep01(x)))
        else:
            coverage = torch.where(dist <= float(f32(radius)), 1.0, 0.0)
        return material * coverage

    def rebuild_brush_lut(self):
        params = (self.properties.size, self.properties.hardness,
                  self.properties.anti_aliased)
        if params == self._lut_params:
            return
        self._lut_params = params
        self._lut_on = {}
        radius = self.properties.size / 2.0
        if radius < 0.001:
            self._lut = np.zeros(256, np.uint8)
            return
        t_sq = np.arange(256, dtype=f32) / f32(255.0)
        dist = np.sqrt(t_sq, dtype=f32) * f32(radius)
        alpha = self.compute_brush_alpha(torch.from_numpy(dist), radius).numpy()
        self._lut = np.minimum(np.floor(alpha * f32(255.0) + f32(0.5)), 255.0).astype(np.uint8)

    def _lut_tensor(self, device) -> torch.Tensor:
        if device not in self._lut_on:
            self._lut_on[device] = resident(self._lut, device)
        return self._lut_on[device]

    # -- stamping ----------------------------------------------------------

    def draw_circle(self, img: torch.Tensor, pos, is_eraser=False,
                    use_secondary=False, primary=(0.0, 0.0, 0.0, 1.0),
                    secondary=(1.0, 1.0, 1.0, 1.0), mask=None):
        """One stamp at `pos`, mutating `img` (u8 [H, W, 4] tensor) in place
        on its device; `mask` is the selection (a host array or a tensor)."""
        check_target(img)
        dev = img.device
        self.rebuild_brush_lut()
        # per-stamp counter increment (draw_circle_and_get_bounds :872)
        self.stamp_counter = (self.stamp_counter + 1) & 0xFFFFFFFF
        h, w = img.shape[:2]
        cx, cy = f32(pos[0]), f32(pos[1])
        if self.properties.scatter > 0.01:
            # scatter each stamp by up to scatter*diameter, hash-seeded
            # (brush_render.rs:179-193); all-f32 offset math
            from paintfe_tpu_torch.tools.brush_tips import hash_unit

            diam = f32(self.properties.size)
            sc = f32(self.properties.scatter)
            h1 = hash_unit(float(cx), float(cy), self.stamp_counter)
            h2 = hash_unit(float(cy), float(cx),
                           (self.stamp_counter + 99991) & 0xFFFFFFFF)
            cx = f32(cx + (h1 * f32(2.0) - f32(1.0)) * sc * diam)
            cy = f32(cy + (h2 * f32(2.0) - f32(1.0)) * sc * diam)
        radius = f32(self.properties.size / 2.0)
        radius_sq = radius * radius
        if radius_sq < 0.001:
            return
        aa = self.properties.anti_aliased
        draw_radius = radius + f32(0.5) if aa else radius
        draw_radius_sq = draw_radius * draw_radius
        use_direct_alpha = draw_radius > radius
        inv_radius_sq = f32(1.0) / radius_sq

        min_x = int(max(np.floor(cx - draw_radius), 0.0))
        max_x = min(int(np.ceil(cx + draw_radius)), w - 1)
        min_y = int(max(np.floor(cy - draw_radius), 0.0))
        max_y = min(int(np.ceil(cy + draw_radius)), h - 1)
        if min_x > max_x or min_y > max_y:
            return

        color = secondary if use_secondary else primary
        src_r, src_g, src_b, src_a = [f32(c) for c in color]
        src_r8 = np.uint8(src_r * 255.0)
        src_g8 = np.uint8(src_g * 255.0)
        src_b8 = np.uint8(src_b * 255.0)
        if (self.properties.hue_jitter > 0.01
                or self.properties.brightness_jitter > 0.01):
            # per-stamp HSL color jitter (brush_render.rs:226-256); hashes
            # use the NOMINAL position (not the scattered one) and the
            # jitter starts from the f32 color, not the quantized u8
            from paintfe_tpu_torch.tools.brush_tips import jitter_color_unit

            src_r8, src_g8, src_b8 = (np.uint8(v) for v in jitter_color_unit(
                (src_r, src_g, src_b),
                self.properties.hue_jitter, self.properties.brightness_jitter,
                (float(pos[0]), float(pos[1])), self.stamp_counter))
        flow = f32(self.properties.flow)

        xs = torch.arange(min_x, max_x + 1, device=dev, dtype=torch.float32) - float(cx)
        ys = torch.arange(min_y, max_y + 1, device=dev, dtype=torch.float32) - float(cy)
        dist_sq = (xs * xs)[None, :] + (ys * ys)[:, None]
        in_circle = dist_sq <= float(draw_radius_sq)

        if use_direct_alpha:
            alpha = self.compute_brush_alpha(sqrt_f32(dist_sq), radius)
            geom_u8 = torch.clamp(torch.floor(alpha * 255.0 + 0.5), max=255.0).to(torch.uint8)
        else:
            idx = torch.clamp(dist_sq * float(inv_radius_sq) * 255.0, max=255.0).to(torch.int64)
            geom_u8 = self._lut_tensor(dev)[idx]

        # an empty stamp writes nothing below: no read-back to skip it (the
        # counter has already advanced, as in the JAX package's early return)
        active = in_circle & (geom_u8 > 0)
        sel = selected(mask, min_y, max_y + 1, min_x, max_x + 1, dev)
        if sel is not None:
            active &= sel

        geom = ieee_div(geom_u8.float(), 255.0)
        window = img[min_y: max_y + 1, min_x: max_x + 1]
        strength = geom * float(src_a) * float(flow)

        if is_eraser:
            # Preview-eraser-mask semantics (brush_render.rs:345-357): write a
            # growing erase mask as (0,0,0,strength) where strength exceeds
            # the current mask alpha.
            old = ieee_div(window[..., 3].float(), 255.0)
            do = active & (strength >= 0.01) & (strength > old)
            out = [torch.where(do, 0, window[..., k]) for k in range(3)]
            out.append(torch.where(do, (strength * 255.0).to(torch.uint8), window[..., 3]))
            window.copy_(torch.stack(out, dim=-1))
            return

        brush_alpha = strength
        active &= brush_alpha >= 0.01
        mode = self.properties.brush_mode
        if mode == BrushMode.NORMAL:
            ba_u8 = (brush_alpha * 255.0).to(torch.uint8)  # truncating
            do = active & (ba_u8 >= window[..., 3])
            out = [torch.where(do, int(v), window[..., k])
                   for k, v in enumerate((src_r8, src_g8, src_b8))]
            out.append(torch.where(do, ba_u8, window[..., 3]))
        else:
            from paintfe_tpu_torch.core.colorspace import hsl_to_rgb, rgb_to_hsl

            old_r, old_g, old_b = (ieee_div(window[..., k].float(), 255.0) for k in range(3))
            hh, ss, ll = rgb_to_hsl(old_r, old_g, old_b)
            strength = brush_alpha * 0.5
            if mode == BrushMode.DODGE:
                ll = torch.clamp(ll + strength, 0.0, 1.0)
            elif mode == BrushMode.BURN:
                ll = torch.clamp(ll - strength, 0.0, 1.0)
            elif mode == BrushMode.SPONGE:
                ss = torch.clamp(ss - strength, 0.0, 1.0)
            new = hsl_to_rgb(hh, ss, ll)
            out = [torch.where(active, (new[k] * 255.0).to(torch.uint8), window[..., k])
                   for k in range(3)]
            out.append(window[..., 3])
        window.copy_(torch.stack(out, dim=-1))

    def draw_line(self, img: torch.Tensor, start, end, is_eraser=False, use_secondary=False,
                  primary=(0.0, 0.0, 0.0, 1.0), secondary=(1.0, 1.0, 1.0, 1.0),
                  mask=None):
        """Dense sub-pixel stepped stroke (brush_render.rs:762-835); the
        selection is uploaded once for the line."""
        check_target(img)
        mask = resident(mask, img.device)
        h, w = img.shape[:2]
        x0, y0 = f32(start[0]), f32(start[1])
        x1, y1 = f32(end[0]), f32(end[1])
        dx = x1 - x0
        dy = y1 - y0
        distance = f32(np.sqrt(dx * dx + dy * dy))
        if distance < 0.1:
            if x0 >= 0.0 and int(x0) < w and y0 >= 0.0 and int(y0) < h:
                self.draw_circle(img, (x0, y0), is_eraser, use_secondary,
                                 primary, secondary, mask)
            return
        steps = int(np.ceil(distance / f32(1.0)))
        for i in range(steps + 1):
            t = f32(i) / f32(steps)
            x = x0 + dx * t
            y = y0 + dy * t
            if x >= 0.0 and int(x) < w and y >= 0.0 and int(y) < h:
                self.draw_circle(img, (x, y), is_eraser, use_secondary,
                                 primary, secondary, mask)
