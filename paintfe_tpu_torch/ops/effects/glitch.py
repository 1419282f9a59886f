"""Glitch effects: pixel drag (row shifts) and RGB displace
(paintfe_tpu.ops.effects.glitch counterpart).

Behavioral contract: src/ops/effects/glitch.rs — pixel_drag_core
(:44-99), rgb_displace_core (:142-196).

The row hashes of pixel drag depend only on the row and the seed: they are
H values of the host `hash_f32` (utils/hashing, bit-identical to the JAX
package), uploaded.  The direction's cos and sin are the JAX package's own
host f32 calls, copied (ROADMAP C2: host scalars).  The source columns and
rows are computed on the device in f32 and rounded half away from zero,
and both ops are gathers there: byte-equal to the JAX package.  Each
function takes a tensor (run where it is) or a numpy image (moved to
`device`, the card unless the caller passes "cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import as_image
from paintfe_tpu_torch.ops.common import masked as _masked
from paintfe_tpu_torch.utils.hashing import hash_f32
from paintfe_tpu_torch.utils.quant import round_half_away

f32 = np.float32


def pixel_drag(img, seed: int, amount: float, distance: int, direction: float,
               mask=None, device="cuda") -> torch.Tensor:
    """Rows with hash(y, 0, seed) <= amount/100 shift by
    hash(y, 1, seed) * distance along the direction (glitch.rs:44-99)."""
    x = as_image(img, device)
    h, w = x.shape[:2]
    dev = x.device
    dir_rad = f32(f32(direction) * (f32(np.pi) / f32(180.0)))
    dx_dir = float(f32(np.cos(dir_rad)))
    dy_dir = float(f32(np.sin(dir_rad)))
    dist = f32(max(int(distance), 1))
    thresh = f32(f32(amount) / f32(100.0))
    ys = np.arange(h, dtype=np.uint32)
    affected = hash_f32(ys, np.zeros_like(ys), int(seed)) <= thresh
    drag = (hash_f32(ys, np.ones_like(ys), int(seed)) * dist).astype(np.int32)
    dragf = torch.from_numpy(drag.astype(f32)).to(dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    sxf = xs - dragf * dx_dir
    syf = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - dragf * dy_dir
    sx = torch.clamp(round_half_away(sxf).int(), 0, w - 1).long()
    sy = torch.clamp(round_half_away(syf).int(), 0, h - 1).long().expand(h, w)
    dragged = x[sy, sx]
    rows = torch.from_numpy(affected).to(dev)[:, None, None]
    return _masked(x, torch.where(rows, dragged, x), mask)


def rgb_displace(img, r_offset=(0, 0), g_offset=(0, 0), b_offset=(0, 0), mask=None,
                 device="cuda") -> torch.Tensor:
    """Per-channel integer offset sample, edges clamped; alpha from the
    centre (glitch.rs:142-196)."""
    x = as_image(img, device)
    h, w = x.shape[:2]

    def take(off, c):
        xi = torch.from_numpy(np.clip(np.arange(w) + int(off[0]), 0, w - 1)).to(x.device)
        yi = torch.from_numpy(np.clip(np.arange(h) + int(off[1]), 0, h - 1)).to(x.device)
        return x[..., c].index_select(0, yi).index_select(1, xi)

    out = torch.stack([take(r_offset, 0), take(g_offset, 1), take(b_offset, 2), x[..., 3]],
                      dim=-1)
    return _masked(x, out, mask)
