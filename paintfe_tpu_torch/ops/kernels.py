"""K-blur and K-median: the fused two-pass Gaussian blur and the window
median, each a kernel with its plain version.

Counterparts of paintfe_tpu/ops/pallas_kernels.py's gaussian_blur_fused /
gaussian_blur_fused_planar and median_pallas.  The kernels are hand-written
CUDA for Hopper (csrc/gaussian_blur.cu, csrc/median.cu);
`gaussian_blur_plain` and `median_plain` are the same computations in plain
torch ops (the JAX package's _gaussian_fn, filters.py:96-114, and its
Batcher network, filters.py:433-454).

`gaussian_blur_fused` and `median_kernel` launch their kernel for a CUDA
tensor and take the plain version for a CPU tensor; every other case
raises.  Each counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import functools

import torch

from paintfe_tpu_torch.ops.filters import _oddeven_merge_network, gaussian_kernel
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


# ---------------------------------------------------------------------------
# K-median
# ---------------------------------------------------------------------------

# csrc/median.cu's output tile: the staged route needs
# (MEDIAN_TILE + 2r)^2 u32 of shared memory.
MEDIAN_TILE = 32


def median_route(r: int) -> str:
    """Which route of K-median runs at radius r: "staged" (the tile and its
    halo in shared memory) or "global" (the window read through L2)."""
    return "staged" if (MEDIAN_TILE + 2 * r) ** 2 * 4 <= MAX_SMEM else "global"


@functools.lru_cache(maxsize=32)
def _median_layers(k2: int):
    """The Batcher network for k2 inputs pruned to output k2 // 2 (only the
    compare-exchanges that can reach the median, as the Pallas kernel's
    _median_network), grouped into layers of disjoint comparators in
    network order: each layer is a pair of index lists (lo wires, hi wires)."""
    live = {k2 // 2}
    kept = []
    for a, b in reversed(_oddeven_merge_network(k2)):
        if a in live or b in live:
            kept.append((a, b))
            live.update((a, b))
    depth = [0] * k2
    layers = []
    for a, b in reversed(kept):
        d = max(depth[a], depth[b])
        if d == len(layers):
            layers.append(([], []))
        layers[d][0].append(a)
        layers[d][1].append(b)
        depth[a] = depth[b] = d + 1
    return layers


def median_plain(img: torch.Tensor, r: int) -> torch.Tensor:
    """Plain torch per-channel median of the (2r+1)^2 window of u8
    [..., H, W, 4], edges replicated: the (2r+1)^2 edge-clamped shifted
    views through the Batcher network, one layer of disjoint
    compare-exchanges at a time."""
    k = 2 * r + 1
    h, w = img.shape[-3], img.shape[-2]
    rows = torch.arange(h, device=img.device)
    cols = torch.arange(w, device=img.device)
    taps = torch.stack([
        img.index_select(-3, torch.clamp(rows + dy, 0, h - 1))
           .index_select(-2, torch.clamp(cols + dx, 0, w - 1))
        for dy in range(-r, r + 1) for dx in range(-r, r + 1)])
    for lo, hi in _median_layers(k * k):
        lo = torch.tensor(lo, device=img.device)
        hi = torch.tensor(hi, device=img.device)
        a, b = taps[lo], taps[hi]
        taps[lo] = torch.minimum(a, b)
        taps[hi] = torch.maximum(a, b)
    return taps[k * k // 2]


def median_kernel(img: torch.Tensor, r: int) -> torch.Tensor:
    """Exact per-channel window median of u8 [H, W, 4] or [B, H, W, 4] at
    radius r >= 1, edges replicated (K-median)."""
    r = int(r)
    if not 1 <= r < 1 << 29:
        raise ValueError(f"median_kernel: radius {r} out of range")
    if img.device.type == "cpu":
        return median_plain(img, r)
    check_rgba_u8(img, "median_kernel")
    from paintfe_tpu_torch.utils.cuda_build import check, load_library

    b, h, w = (1, *img.shape[:2]) if img.dim() == 3 else img.shape[:3]
    if b > 65535:
        raise ValueError(f"median_kernel: batch {b} exceeds 65535")
    out = torch.empty_like(img)
    if b * h * w == 0:
        return out
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pfe_median(img.data_ptr(), out.data_ptr(), b, h, w, r,
                            int(median_route(r) == "staged"), stream)
    check(rc, "median_kernel")
    median_kernel.launches += 1
    return out


median_kernel.launches = 0
