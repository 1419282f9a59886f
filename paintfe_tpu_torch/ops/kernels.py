"""K-blur: the fused two-pass Gaussian blur kernel and its plain version.

Counterpart of the blur part of paintfe_tpu/ops/pallas_kernels.py
(gaussian_blur_fused / gaussian_blur_fused_planar).  The kernel is
hand-written CUDA for Hopper (csrc/gaussian_blur.cu); `gaussian_blur_plain`
is the same computation in plain torch ops (the JAX package's
_gaussian_fn, filters.py:96-114).

`gaussian_blur_fused` launches the kernel for a CUDA tensor and takes the
plain version for a CPU tensor; every other case raises.  It counts its
launches in `gaussian_blur_fused.launches`.
"""

from __future__ import annotations

import torch

from paintfe_tpu_torch.ops.filters import gaussian_kernel
from paintfe_tpu_torch.utils.quant import round_u8

# Tile geometry: TILE_W is csrc/blur_tile.cuh's kTileW.
TILE_W = 32
MAX_TILE_H = 64
MIN_TILE_H = 8
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


def tile_rows(r: int, extra_smem: int = 0) -> int:
    """Output rows of one tile for blur radius `r`: at most MAX_TILE_H,
    shrunk so the H-pass sums of the tile and its halo, (th + 2r) rows of
    TILE_W float4, plus `extra_smem` bytes fit in shared memory.  0 means
    no tile of MIN_TILE_H rows fits: the split kernels run instead."""
    th = min(MAX_TILE_H, (MAX_SMEM - extra_smem) // (TILE_W * 16) - 2 * r)
    return th if th >= MIN_TILE_H else 0


def gaussian_blur_plain(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Plain torch separable Gaussian of u8 [..., H, W, 4]: H pass then V
    pass, each an ordered f32 sum over taps of edge-clamped shifted copies,
    then round half up."""
    taps = gaussian_kernel(float(sigma))
    r = len(taps) // 2
    h, w = img.shape[-3], img.shape[-2]
    src = img.float()
    cols = torch.arange(w, device=img.device)
    acc = torch.zeros_like(src)
    for k, t in enumerate(taps):  # H pass, reference tap order
        idx = torch.clamp(cols + (k - r), 0, w - 1)
        acc = acc + src.index_select(-2, idx) * float(t)
    rows = torch.arange(h, device=img.device)
    out = torch.zeros_like(acc)
    for k, t in enumerate(taps):  # V pass
        idx = torch.clamp(rows + (k - r), 0, h - 1)
        out = out + acc.index_select(-3, idx) * float(t)
    return round_u8(out)


def check_rgba_u8(t: torch.Tensor, name: str, ndims=(3, 4)):
    """Validate a tensor handed to a kernel: CUDA, u8, [..., H, W, 4],
    contiguous and u32-aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.uint8:
        raise TypeError(f"{name}: expected torch.uint8, got {t.dtype}")
    if t.dim() not in ndims or t.shape[-1] != 4:
        raise ValueError(f"{name}: expected shape {'/'.join(map(str, ndims))}"
                         f"-d [..., H, W, 4], got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 4:
        raise ValueError(f"{name}: expected a contiguous, 4-byte aligned tensor")


def gaussian_blur_fused(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Bit-exact Gaussian blur of u8 [H, W, 4] or [B, H, W, 4] with both
    separable passes in one kernel (K-blur)."""
    if img.device.type == "cpu":
        return gaussian_blur_plain(img, sigma)
    check_rgba_u8(img, "gaussian_blur_fused")
    from paintfe_tpu_torch.utils.cuda_build import check, load_library

    taps = gaussian_kernel(float(sigma))
    nt = len(taps)
    r = nt // 2
    b, h, w = (1, *img.shape[:2]) if img.dim() == 3 else img.shape[:3]
    if b > 65535:
        raise ValueError(f"gaussian_blur_fused: batch {b} exceeds 65535")
    out = torch.empty_like(img)
    if b * h * w == 0:
        return out
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        th = tile_rows(r)
        if th:
            rc = lib.pfe_blur_tiled(img.data_ptr(), out.data_ptr(), b, h, w,
                                    taps.ctypes.data, nt, th, stream)
        else:
            tmp = torch.empty((b, h, w, 4), dtype=torch.float32, device=img.device)
            taps_dev = torch.from_numpy(taps).to(img.device)
            rc = lib.pfe_blur_split(img.data_ptr(), tmp.data_ptr(),
                                    out.data_ptr(), b, h, w,
                                    taps_dev.data_ptr(), nt, stream)
    check(rc, "gaussian_blur_fused")
    gaussian_blur_fused.launches += 1
    return out


gaussian_blur_fused.launches = 0


def gaussian_blur_fused_planar(planar: torch.Tensor, h: int, w: int,
                               sigma: float) -> torch.Tensor:
    """Blur a channel-planar u8 [4, H, W] image; returns planar [4, H, W]."""
    img = planar[:, :h, :w].permute(1, 2, 0).contiguous()
    return gaussian_blur_fused(img, sigma).permute(2, 0, 1).contiguous()
