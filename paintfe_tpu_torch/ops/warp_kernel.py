"""K-warp: the bilinear gather of u8 RGBA images at f32 source
coordinates, a kernel and its plain version.

Counterpart of paintfe_tpu/ops/warp_kernel.py's gather_bilinear_u8 (and
gather_bilinear_u8_planned).  The kernel is hand-written CUDA for Hopper
(csrc/warp_bilinear.cu): a thread gathers the taps of WARP_PX adjacent
output pixels directly, so the TPU kernel's window planner, buckets, plan
caches, `defer_check` and infeasible-field fallback have no counterpart,
and the wrapper never returns None.  `gather_bilinear_plain` is the same
computation in plain torch ops, the oracles of the two modes:

- "zero": ops/transform._bilinear_gather_zero (taps outside the source are
  0, successive lerps, a pixel with x0 < -1, y0 < -1, x0 >= Ws or y0 >= Hs
  is transparent black);
- "clamp": round_u8(effects/distort.sample_bilinear) (edge-clamped taps,
  product-form weights).

`gather_bilinear_u8` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors; every other case raises.  It counts its
launches in `gather_bilinear_u8.launches`.  `warp_split` says which of the
kernel's paths a launch takes.  Coordinates are meant finite and within
+-2^24: beyond that the kernel's float-to-int conversion saturates and a
NaN coordinate gives 0 channels, where XLA and torch on the CPU may differ.
"""

from __future__ import annotations

import torch

from paintfe_tpu_torch.ops.kernels import check_rgba_u8, device_guard, launch_stream
from paintfe_tpu_torch.utils.quant import round_u8

MODES = ("zero", "clamp")


# csrc/warp_bilinear.cu kPx: adjacent output pixels a thread computes; its
# grid's 65535 blocks of kBlockY = 8 rows bound the output height
WARP_PX = 4
_MAX_ROWS = 65535 * 8


def warp_split(w: int, *addresses: int):
    """How K-warp covers an output row of width w, given the addresses of
    the two fields and the output: ("vector", groups, 0) when w is a
    multiple of WARP_PX and every address is 16-byte aligned (one float4
    load a field and one uint4 store a group of WARP_PX pixels), else
    ("scalar", groups, tail): 4-byte accesses, with a last group of `tail`
    = w % WARP_PX pixels when that is not 0.  `groups` counts the whole
    groups of a row."""
    low = 0
    for a in addresses:
        low |= a
    if w % WARP_PX == 0 and low % 16 == 0:
        return "vector", w // WARP_PX, 0
    return "scalar", w // WARP_PX, w % WARP_PX


def _check_fields(sx: torch.Tensor, sy: torch.Tensor, like: torch.Tensor):
    device = like.device
    if (sx.device != device or sy.device != device or sx.dtype != torch.float32
            or sy.dtype != torch.float32 or sx.dim() != 2
            or not sx.is_contiguous() or not sy.is_contiguous()):
        raise ValueError(f"gather_bilinear_u8: sx and sy must be contiguous f32 [H, W] "
                         f"tensors on {device}, got {sx.dtype} {tuple(sx.shape)} on "
                         f"{sx.device} and {sy.dtype} {tuple(sy.shape)} on {sy.device}")
    if sx.shape != sy.shape:
        raise ValueError(f"gather_bilinear_u8: sx {tuple(sx.shape)} and sy "
                         f"{tuple(sy.shape)} differ")


def gather_bilinear_plain(src: torch.Tensor, sx: torch.Tensor,
                          sy: torch.Tensor, mode: str = "zero") -> torch.Tensor:
    """Plain torch bilinear gather: src u8 [..., Hs, Ws, 4], sx/sy f32
    [H, W] (shared by the batch) -> u8 [..., H, W, 4]."""
    from paintfe_tpu_torch.ops.effects.distort import sample_bilinear

    if mode == "clamp":
        return round_u8(sample_bilinear(src, sx, sy))
    if mode != "zero":
        raise ValueError(f"gather_bilinear: mode must be one of {MODES}, got {mode!r}")
    hs, ws = src.shape[-3], src.shape[-2]
    x0 = torch.floor(sx).to(torch.int32)
    y0 = torch.floor(sy).to(torch.int32)
    oob = (x0 < -1) | (y0 < -1) | (x0 >= ws) | (y0 >= hs)
    fx = (sx - x0.float())[..., None]
    fy = (sy - y0.float())[..., None]

    def sample(xi, yi):
        inb = (xi >= 0) & (yi >= 0) & (xi < ws) & (yi < hs)
        p = src[..., torch.clamp(yi, 0, hs - 1).long(),
                torch.clamp(xi, 0, ws - 1).long(), :]
        return torch.where(inb[..., None], p.float(), 0.0)

    tl = sample(x0, y0)
    tr = sample(x0 + 1, y0)
    bl = sample(x0, y0 + 1)
    br = sample(x0 + 1, y0 + 1)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    out = round_u8(top + (bot - top) * fy)
    return torch.where(oob[..., None], torch.zeros_like(out), out)


def gather_bilinear_u8(src: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                       mode: str = "zero") -> torch.Tensor:
    """Bilinear gather `out[..., y, x, :] = bilerp(src, sx[y, x], sy[y, x])`
    of u8 [Hs, Ws, 4] or [B, Hs, Ws, 4] at f32 [H, W] coordinates (one
    field for the whole batch), in mode "zero" or "clamp" (K-warp)."""
    if mode not in MODES:
        raise ValueError(f"gather_bilinear_u8: mode must be one of {MODES}, "
                         f"got {mode!r}")
    if src.device.type == "cpu":
        return gather_bilinear_plain(src, sx, sy, mode)
    check_rgba_u8(src, "gather_bilinear_u8")
    _check_fields(sx, sy, src)
    from paintfe_tpu_torch.utils.cuda_build import check, count_launch, load_library

    b, hs, ws = (1, *src.shape[:2]) if src.dim() == 3 else src.shape[:3]
    h, w = sx.shape
    if b > 65535 or h > _MAX_ROWS:
        raise ValueError(f"gather_bilinear_u8: batch {b} or height {h} exceeds "
                         f"65535 or {_MAX_ROWS}")
    out = torch.empty((*src.shape[:-3], h, w, 4), dtype=torch.uint8,
                      device=src.device)
    if out.numel() == 0:
        return out
    if hs * ws == 0:
        raise ValueError("gather_bilinear_u8: empty source image")
    lib = load_library()
    fields = (sx.data_ptr(), sy.data_ptr())
    vec = warp_split(w, *fields, out.data_ptr())[0] == "vector"
    with device_guard(src.device):
        rc = lib.pfe_warp_bilinear(src.data_ptr(), *fields, out.data_ptr(), b, hs, ws,
                                   h, w, MODES.index(mode), vec, launch_stream(src.device))
    check(rc, "gather_bilinear_u8")
    count_launch(gather_bilinear_u8)
    return out


gather_bilinear_u8.launches = 0
