"""K-blur, K-median, K-composite and K-pass: the fused two-pass Gaussian
blur, the window median, the layer compositor and the single separable
blur pass, each a kernel with its plain version.

Counterparts of paintfe_tpu/ops/pallas_kernels.py's gaussian_blur_fused /
gaussian_blur_fused_planar, median_pallas, composite_stack_pallas and
gaussian_blur_pallas.  The kernels are hand-written CUDA for Hopper
(csrc/gaussian_blur.cu, csrc/median.cu, csrc/composite.cu,
csrc/blur_pass.cu); `gaussian_blur_plain`, `median_plain`,
`composite_stack_plain` and `gaussian_blur_pass_plain` are the same
computations in plain torch ops (the JAX package's _gaussian_fn,
filters.py:96-114, its Batcher network, filters.py:433-454, the fold of
core/composite.composite_stack_static, and one pass of _conv_pass).

`gaussian_blur_fused`, `median_kernel`, `composite_stack_kernel` and
`gaussian_blur_pass` launch their kernel for a CUDA tensor and take the
plain version for a CPU tensor; every other case raises.  Each counts its
launches in `<wrapper>.launches` (utils/cuda_build.count_launch: one lock,
so threads launching at once lose no count).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from paintfe_tpu_torch.core.blend import blend_u8
from paintfe_tpu_torch.ops.filters import _oddeven_merge_network, gaussian_kernel
from paintfe_tpu_torch.utils.device import read_on_current_stream, upload_shared
from paintfe_tpu_torch.utils.profiling import span
from paintfe_tpu_torch.utils.quant import round_u8

# Tile geometry: TILE_W is csrc/blur_tile.cuh's kTileW.
TILE_W = 32
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper

# K-blur's staged tile (blur_tile.cuh blur_h_pass / blur_v_pass): TILE_W
# output columns by blur_tile_rows(r) rows, in strips of blur_sums(r) (the
# sums a thread computes); the H sums, (th + 2r) rows of TILE_W float4,
# share MAX_SMEM with the source rows staged at once, (TILE_W + 2r) | 1 u32
# each.  Up to BLUR_SHORT_MAX_R a thread computes BLUR_SHORT_Q sums in
# BLUR_SHORT_TILE_H-row tiles, at four blocks an SM; above it BLUR_Q sums
# in BLUR_TILE_H-row tiles, at two.  The tiled route runs while
# BLUR_MIN_CHUNK source rows fit beside the sums (r <= 140), the split
# route past that.  Set on NVIDIA H100 80GB HBM3 at 700 W from one-off
# sweeps of the tile height and of the sums a thread at 3840x2160 (PERF.md,
# PR 4, "K-blur: the geometry"); chip_smoke.time_route_limits times both
# tiles at r = 1..6, and the tile beside the split route at r = 140, 141.
BLUR_Q = 8
BLUR_TILE_H = 128
BLUR_SHORT_MAX_R = 4
BLUR_SHORT_Q = 4
BLUR_SHORT_TILE_H = 64
BLUR_MIN_CHUNK = 18


def blur_sums(r: int) -> int:
    """Sums a thread of K-blur's staged tile computes at blur radius r."""
    return BLUR_SHORT_Q if r <= BLUR_SHORT_MAX_R else BLUR_Q


def blur_src_pitch(r: int) -> int:
    return (TILE_W + 2 * r) | 1


def blur_chunk_rows(th: int, r: int, reserved: int = 0) -> int:
    """blur_tile.cuh blur_chunk_rows: source rows staged at once, as many
    as fit beside the sums and `reserved` bytes of the kernel's own tables,
    spread evenly over the chunks; 0 if none fits."""
    used = (th + 2 * r) * TILE_W * 16 + reserved
    room = max(MAX_SMEM - used, 0) // (blur_src_pitch(r) * 4)
    if room < 1:
        return 0
    rows = th + 2 * r
    chunks = -(-rows // room)
    return -(-rows // chunks)


def blur_tile_bytes(th: int, r: int, reserved: int = 0) -> int:
    """blur_tile.cuh blur_tile_bytes: the tile's shared memory, its
    kernel's tables included."""
    return (reserved + (th + 2 * r) * TILE_W * 16
            + blur_chunk_rows(th, r, reserved) * blur_src_pitch(r) * 4)


def blur_tile_rows(r: int, reserved: int = 0) -> int:
    """K-blur's output rows of one tile at blur radius `r`:
    BLUR_SHORT_TILE_H up to BLUR_SHORT_MAX_R, then BLUR_TILE_H while
    BLUR_MIN_CHUNK source rows fit beside the sums (and `reserved` bytes of
    tables), else 0: the split kernels run."""
    if r <= BLUR_SHORT_MAX_R:
        return BLUR_SHORT_TILE_H
    return BLUR_TILE_H if blur_chunk_rows(BLUR_TILE_H, r, reserved) >= BLUR_MIN_CHUNK else 0


# K-chain (csrc/fused_chain.cu) runs K-blur's staged tile with its tables
# ahead of the sums in the same shared memory: three tables of 256 f32 (the
# unit table, brightness/contrast then levels, soft-light's d), then the
# 2r + 1 taps padded to four f32.
CHAIN_TABLES = 3


def chain_tables_bytes(r: int) -> int:
    """csrc/fused_chain.cu chain_tables_bytes at blur radius r."""
    return (CHAIN_TABLES * 256 + -(-(2 * r + 1) // 4) * 4) * 4


def chain_tile_rows(r: int) -> int:
    """K-chain's output rows of one tile at blur radius r: K-blur's tile
    with the chain's tables beside it, else 0: K-blur runs (whatever route
    it takes), then the chain's tail alone."""
    return blur_tile_rows(r, chain_tables_bytes(r))


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


def launch_stream(device: torch.device) -> int:
    """The raw handle of `device`'s current CUDA stream: what
    torch.cuda.current_stream(device).cuda_stream gives, without building a
    Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def device_guard(device: torch.device):
    """torch.cuda.device(device) where `device` is not the current device,
    else a context that does nothing: a launch must go to the tensor's
    card, and switching to the current one costs a call's host time."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
    from paintfe_tpu_torch.utils.cuda_build import check, count_launch, load_library

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
    with device_guard(img.device):
        stream = launch_stream(img.device)
        th = blur_tile_rows(r)
        if th:
            rc = lib.pfe_blur_tiled(img.data_ptr(), out.data_ptr(), b, h, w,
                                    taps.ctypes.data, nt, th, blur_sums(r), stream)
        else:
            tmp = torch.empty((b, h, w, 4), dtype=torch.float32, device=img.device)
            taps_dev = torch.from_numpy(taps).to(img.device)
            rc = lib.pfe_blur_split(img.data_ptr(), tmp.data_ptr(),
                                    out.data_ptr(), b, h, w,
                                    taps_dev.data_ptr(), nt, stream)
    check(rc, "gaussian_blur_fused")
    count_launch(gaussian_blur_fused)
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

# The largest radius of K-median's network route (csrc/median_network.cuh
# holds one network per radius up to it; ops/median_network.py writes it).
# At every r = 1..5 on a 3840x2160 frame the network beat the staged
# counting route by 3x or more (chip_smoke.time_route_limits on NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md, PR 4); r = 5 is the largest radius measured.
MEDIAN_NETWORK_MAX_R = 5
# csrc/median.cu's counting routes: the staged one needs
# (MEDIAN_TILE + 2r)^2 u32 of shared memory.
MEDIAN_TILE = 32
# pfe_median's route codes
_MEDIAN_ROUTES = {"global": 0, "staged": 1, "network": 2}


def median_route(r: int) -> str:
    """Which route of K-median runs at radius r: "network" (a selection
    network), "staged" (the counting search on the tile and its halo in
    shared memory) or "global" (the counting search reading the window
    through L2)."""
    if r <= MEDIAN_NETWORK_MAX_R:
        return "network"
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
    from paintfe_tpu_torch.utils.cuda_build import check, count_launch, load_library

    b, h, w = (1, *img.shape[:2]) if img.dim() == 3 else img.shape[:3]
    if b > 65535:
        raise ValueError(f"median_kernel: batch {b} exceeds 65535")
    out = torch.empty_like(img)
    if b * h * w == 0:
        return out
    lib = load_library()
    with device_guard(img.device):
        stream = launch_stream(img.device)
        rc = lib.pfe_median(img.data_ptr(), out.data_ptr(), b, h, w, r,
                            _MEDIAN_ROUTES[median_route(r)], stream)
    check(rc, "median_kernel")
    count_launch(median_kernel)
    return out


median_kernel.launches = 0


# ---------------------------------------------------------------------------
# K-composite
# ---------------------------------------------------------------------------

# csrc/composite.cu's kMaxLayers: layers folded by one launch
COMPOSITE_CHUNK = 32


def composite_unit_table() -> np.ndarray:
    """The u8 -> f32 table each block of csrc/composite.cu fills: entry i is
    i / 255 as one correctly rounded f32 divide, the conversion of
    core/blend.blend_u8 (a multiply by 1 / 255 rounds 126 of the 256 values
    differently)."""
    return np.arange(256, dtype=np.float32) / np.float32(255.0)


def as_u8_tensor(x):
    """A tensor as it is; a u8 numpy array as a tensor on the CPU; None as
    None."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.uint8))


def layer_list(layers) -> list:
    """A stack ([N, ...] tensor or array) or a sequence of tensors, arrays
    or None, as a list of tensors (or None)."""
    if isinstance(layers, (list, tuple)):
        return [as_u8_tensor(t) for t in layers]
    return list(as_u8_tensor(layers).unbind(0))


def host_values(values, dtype) -> list:
    """Per-layer values (a sequence, array or tensor) as a host list of
    Python numbers of `dtype` (np.float32 values stay exact)."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype).reshape(-1).tolist()


def composite_stack_plain(layers, modes, opacities, conceal=None, init=None):
    """Plain torch fold of u8 layers bottom-up over `init` (transparent when
    None): each layer's alpha scaled by its conceal mask in integer math
    (a * (255 - m) // 255; a None mask is no mask), then blend_u8 with its
    mode and opacity.  `layers` is [N, H, W, 4] or a sequence of [H, W, 4];
    `conceal` is None, [N, H, W] or a sequence of [H, W] or None."""
    layers = layer_list(layers)
    masks = [None] * len(layers) if conceal is None else layer_list(conceal)
    acc = as_u8_tensor(init) if init is not None else torch.zeros_like(layers[0])
    for px, mask, mode, opacity in zip(layers, masks, host_values(modes, np.int64),
                                       host_values(opacities, np.float32)):
        if mask is not None:
            a = px[..., 3].int() * (255 - mask.int()) // 255
            px = torch.cat([px[..., :3], a.to(torch.uint8)[..., None]], dim=-1)
        acc = blend_u8(acc, px, mode, opacity)
    return acc


def _check_plane(t: torch.Tensor, name: str, like: torch.Tensor):
    if (t.device != like.device or t.dtype != torch.uint8
            or tuple(t.shape) != tuple(like.shape[:2]) or not t.is_contiguous()):
        raise ValueError(f"composite_stack_kernel: {name} must be a contiguous "
                         f"u8 {tuple(like.shape[:2])} tensor on {like.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def composite_stack_kernel(layers, modes, opacities, conceal=None, init=None):
    """Fold u8 layers bottom-up over `init` (K-composite): the contract of
    composite_stack_plain, on the layers' device.  Stacks longer than
    COMPOSITE_CHUNK layers fold in chunks, one launch each.  Spans
    `pfe.kcomposite.prepare` (the layer list; on a card, the host values,
    the checks and each chunk's pointer arrays too) and, on a card,
    `pfe.kcomposite.launch` (a chunk's output and launch)."""
    with span("pfe.kcomposite.prepare"):
        layers = layer_list(layers)
        if not layers:
            raise ValueError("composite_stack_kernel: no layers")
        first, init = layers[0], as_u8_tensor(init)
        cpu = first.device.type == "cpu"
        chunks = None if cpu else _composite_chunks(layers, modes, opacities, conceal, init)
    if cpu:
        return composite_stack_plain(layers, modes, opacities, conceal, init)
    from paintfe_tpu_torch.utils.cuda_build import check, count_launch, load_library

    h, w = first.shape[:2]
    acc = init
    if h * w == 0:
        return torch.empty_like(first)
    lib = load_library()
    with device_guard(first.device):
        stream = launch_stream(first.device)
        for args in chunks:
            with span("pfe.kcomposite.launch"):
                out = torch.empty_like(first)
                rc = lib.pfe_composite(*args, None if acc is None else acc.data_ptr(),
                                       out.data_ptr(), h * w, stream)
                check(rc, "composite_stack_kernel")
                count_launch(composite_stack_kernel)
            acc = out
    return acc


def _composite_chunks(layers, modes, opacities, conceal, init) -> list:
    """The checked arguments of each K-composite launch, one chunk of at
    most COMPOSITE_CHUNK layers each: (layer pointers, conceal pointers,
    modes, opacities, count)."""
    first = layers[0]
    modes = host_values(modes, np.int64)
    # clip_opacity for the whole stack in one numpy call
    opacities = np.clip(np.asarray(host_values(opacities, np.float32), np.float32),
                        np.float32(0.0), np.float32(1.0)).tolist()
    masks = [None] * len(layers) if conceal is None else layer_list(conceal)
    if not len(modes) == len(opacities) == len(masks) == len(layers):
        raise ValueError("composite_stack_kernel: layers, modes, opacities "
                         "and conceal differ in length")
    if any(not 0 <= m <= 24 for m in modes):
        raise ValueError(f"composite_stack_kernel: blend mode out of range in {modes}")
    check_rgba_u8(first, "composite_stack_kernel", ndims=(3,))
    for t in layers[1:] + ([init] if init is not None else []):
        check_rgba_u8(t, "composite_stack_kernel", ndims=(3,))
        if t.device != first.device or t.shape != first.shape:
            raise ValueError(f"composite_stack_kernel: {tuple(t.shape)} on "
                             f"{t.device} differs from {tuple(first.shape)} "
                             f"on {first.device}")
    for m in masks:
        if m is not None:
            _check_plane(m, "conceal", first)
    chunks = []
    for s in range(0, len(layers), COMPOSITE_CHUNK):
        e = min(s + COMPOSITE_CHUNK, len(layers))
        n = e - s
        chunks.append(((ctypes.c_void_p * n)(*[t.data_ptr() for t in layers[s:e]]),
                       (ctypes.c_void_p * n)(*[None if m is None else m.data_ptr()
                                               for m in masks[s:e]]),
                       (ctypes.c_int * n)(*modes[s:e]),
                       (ctypes.c_float * n)(*opacities[s:e]), n))
    return chunks


composite_stack_kernel.launches = 0


def composite_stack_pallas(layers, modes, opacities):
    """composite_stack_pallas's contract (pallas_kernels.py:257): the fold
    with no conceal and a transparent start, on K-composite."""
    return composite_stack_kernel(layers, modes, opacities)


# ---------------------------------------------------------------------------
# K-pass
# ---------------------------------------------------------------------------


def gaussian_blur_pass_plain(x: torch.Tensor, taps) -> torch.Tensor:
    """Plain torch edge-clamped pass along the last axis of f32 [..., W]:
    out[..., i] = sum over k in order of x[..., clamp(i + k - r)] * taps[k],
    summed from 0."""
    taps = np.asarray(taps, np.float32)
    r = len(taps) // 2
    w = x.shape[-1]
    cols = torch.arange(w, device=x.device)
    acc = torch.zeros_like(x)
    for k, t in enumerate(taps):
        acc = acc + x.index_select(-1, torch.clamp(cols + (k - r), 0, w - 1)) * float(t)
    return acc


# K-pass's staged route (csrc/blur_pass.cu): a block computes one segment
# of a row, PASS_Q outputs a thread, at most PASS_MAX_SEG outputs a block
# (64 threads; chip_smoke.time_route_limits times it beside segments of 960
# and beside the global route at 3840x2160).
PASS_Q = 4
PASS_MAX_SEG = 256


def pass_segment(w: int) -> int:
    """Outputs of one block's segment for rows of width w: the row split
    evenly into as few segments as PASS_MAX_SEG allows, rounded up to
    PASS_Q."""
    nseg = -(-w // PASS_MAX_SEG)
    return -(-(-(-w // nseg)) // PASS_Q) * PASS_Q


def pass_smem_bytes(seg: int, r: int) -> int:
    """csrc/blur_pass.cu's shared memory at segment length seg and radius
    r: the segment, its halo and the reach of the last 16-byte window load,
    then the taps, both padded to four floats."""
    nt4 = -(-(2 * r + 1) // 4) * 4
    return (seg + nt4 + 4 + nt4) * 4


def pass_route(w: int, r: int) -> str:
    """Which route of K-pass runs for rows of width w at radius r: "staged"
    (the segment and its halo in shared memory) while they fit, else
    "global" (one thread an output, the window read through L1)."""
    return "staged" if pass_smem_bytes(pass_segment(w), r) <= MAX_SMEM else "global"


@functools.lru_cache(maxsize=16)
def _taps_on(device: torch.device, taps: bytes) -> torch.Tensor:
    """The f32 taps in device memory, uploaded once per tap set and device
    (utils/device.upload_shared: readable from any stream; a reader marks
    its stream with read_on_current_stream)."""
    return upload_shared(np.frombuffer(taps, np.float32), device)


def gaussian_blur_pass(x: torch.Tensor, taps) -> torch.Tensor:
    """One edge-clamped separable pass along the last axis of a contiguous
    f32 [C, H, W] tensor with f32 taps (K-pass)."""
    if x.device.type == "cpu":
        return gaussian_blur_pass_plain(x, taps)
    taps = np.ascontiguousarray(taps, np.float32)
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("gaussian_blur_pass: expected a contiguous f32 [C, H, W] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if taps.ndim != 1 or len(taps) % 2 == 0:
        raise ValueError(f"gaussian_blur_pass: expected an odd tap count, got {taps.shape}")
    from paintfe_tpu_torch.utils.cuda_build import check, count_launch, load_library

    out = torch.empty_like(x)
    c, h, w = x.shape
    if x.numel() == 0:
        return out
    lib = load_library()
    seg = pass_segment(w) if pass_route(w, len(taps) // 2) == "staged" else 0
    with device_guard(x.device):
        taps_dev = read_on_current_stream(_taps_on(x.device, taps.tobytes()))
        stream = launch_stream(x.device)
        rc = lib.pfe_blur_pass(x.data_ptr(), taps_dev.data_ptr(), out.data_ptr(),
                               c * h, w, len(taps), seg, stream)
    check(rc, "gaussian_blur_pass")
    count_launch(gaussian_blur_pass)
    return out


gaussian_blur_pass.launches = 0


def gaussian_blur_pallas(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of u8 [H, W, C] through two K-pass launches
    (pallas_kernels.py:98-110): H pass on the planar f32 image, transpose,
    V pass, transpose back, round half up."""
    taps = gaussian_kernel(float(sigma))
    planar = img.float().permute(2, 0, 1).contiguous()  # [C, H, W]
    hbuf = gaussian_blur_pass(planar, taps)
    vbuf = gaussian_blur_pass(hbuf.transpose(1, 2).contiguous(), taps)  # [C, W, H]
    return round_u8(vbuf.permute(2, 1, 0))
