"""The headline filter chain: Gaussian blur, brightness/contrast, levels,
sepia with strength, then a soft-light flatten of an overlay.

Counterpart of paintfe_tpu/ops/fused_chain.py.  `fused_chain` is the plain
version, composed from the port's public ops; `fused_chain_kernel` runs the
whole chain in one hand-written CUDA kernel (K-chain, csrc/fused_chain.cu)
for a CUDA tensor and takes the plain version for a CPU tensor.  Both give
the bytes of chaining the script-level ops.  The kernel reads its taps and
levels table from device memory, uploaded once per sigma and per (black,
white, gamma) and cached here; a cached table is complete before any
stream reads it, and each launch marks its stream as a reader
(utils/device.upload_shared, read_on_current_stream).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paintfe_tpu_torch.core.blend import BlendMode, blend_u8, clip_opacity
from paintfe_tpu_torch.ops.filters import gaussian_kernel
from paintfe_tpu_torch.ops.kernels import (_taps_on, blur_sums, chain_tile_rows,
                                           check_rgba_u8, device_guard,
                                           gaussian_blur_fused, gaussian_blur_plain,
                                           launch_stream)
from paintfe_tpu_torch.parallel.pipeline import (_bc_device, _levels_device,
                                                 _sepia_device, bc_factor,
                                                 levels_lut)
from paintfe_tpu_torch.utils.device import read_on_current_stream, upload_shared
from paintfe_tpu_torch.utils.profiling import span

f32 = np.float32


def fused_chain(img, overlay, *, sigma=2.0, brightness=10.0, contrast=20.0,
                black=10.0, white=245.0, gamma=1.1, sepia_strength=0.5,
                blend_mode=None, blend_opacity=0.6):
    """u8 [H, W, 4] x2 -> u8 [H, W, 4], in plain torch ops: gaussian blur +
    _bc_device + _levels_device + _sepia_device + blend_u8."""
    if blend_mode is None:
        blend_mode = BlendMode.SOFT_LIGHT
    x = gaussian_blur_plain(img, sigma)
    x = _bc_device(x, brightness, contrast)
    x = _levels_device(x, black, white, gamma)
    x = _sepia_device(x, sepia_strength)
    return blend_u8(x, overlay, blend_mode, blend_opacity)


@functools.lru_cache(maxsize=16)
def _tail_params(brightness, contrast, sepia_strength, blend_opacity):
    """The five f32 scalars of the kernel's pointwise tail, computed as the
    JAX package's _make_chain_kernel does; once per set of arguments, as a
    read-only array."""
    sep_s = f32(np.clip(sepia_strength, 0.0, 1.0))
    params = np.array([f32(brightness), bc_factor(contrast), sep_s,
                       f32(1.0) - sep_s, clip_opacity(blend_opacity)], f32)
    params.setflags(write=False)
    return params


@functools.lru_cache(maxsize=16)
def _chain_taps(device: torch.device, sigma: float):
    """The blur's taps on `device`, uploaded once per sigma, and their count."""
    taps = gaussian_kernel(sigma)
    return _taps_on(device, taps.tobytes()), len(taps)


@functools.lru_cache(maxsize=16)
def _levels_on(device: torch.device, black: float, white: float, gamma: float):
    """The 256-entry levels table on `device`, built and uploaded once per
    (black, white, gamma)."""
    return upload_shared(levels_lut(black, white, gamma), device)


def fused_chain_kernel(img, overlay, *, sigma=2.0, brightness=10.0,
                       contrast=20.0, black=10.0, white=245.0, gamma=1.1,
                       sepia_strength=0.5, blend_opacity=0.6):
    """One-kernel version of fused_chain (soft-light flatten only);
    bit-identical to it.  Counts its launches in
    `fused_chain_kernel.launches`.  On a card, spans `pfe.kchain.tables`
    (the checks, the tail's parameters, the taps and the levels table,
    with the upload a cache miss makes) and `pfe.kchain.launch` (the
    output's allocation and the launch)."""
    if img.device.type == "cpu" and overlay.device.type == "cpu":
        return fused_chain(img, overlay, sigma=sigma, brightness=brightness,
                           contrast=contrast, black=black, white=white,
                           gamma=gamma, sepia_strength=sepia_strength,
                           blend_opacity=blend_opacity)
    from paintfe_tpu_torch.utils.cuda_build import check, count_launch, load_library

    with span("pfe.kchain.tables"):  # the argument checks, then each table
        check_rgba_u8(img, "fused_chain_kernel", ndims=(3,))
        check_rgba_u8(overlay, "fused_chain_kernel overlay", ndims=(3,))
        if overlay.shape != img.shape or overlay.device != img.device:
            raise ValueError("fused_chain_kernel: overlay must match the image's "
                             "shape and device")
        h, w = img.shape[:2]
        if h * w == 0:
            return torch.empty_like(img)
        lib = load_library()
        params = _tail_params(brightness, contrast, sepia_strength, blend_opacity)
        device = img.device
        guard = device_guard(device)  # made once, entered for the tables and the launch
        with guard:
            taps, nt = _chain_taps(device, float(sigma))
            taps = read_on_current_stream(taps)
            levels = read_on_current_stream(_levels_on(device, black, white, gamma))
    with guard, span("pfe.kchain.launch"):
        out = torch.empty_like(img)
        stream = launch_stream(device)
        r = nt // 2
        th = chain_tile_rows(r)
        if th:
            rc = lib.pfe_chain_tiled(img.data_ptr(), overlay.data_ptr(),
                                     out.data_ptr(), h, w, taps.data_ptr(), nt,
                                     th, blur_sums(r), levels.data_ptr(),
                                     params.ctypes.data, stream)
        else:
            # the tile and its tables do not fit shared memory: K-blur,
            # then the tail
            blurred = gaussian_blur_fused(img, sigma)
            rc = lib.pfe_chain_tail(blurred.data_ptr(), overlay.data_ptr(),
                                    out.data_ptr(), h, w, levels.data_ptr(),
                                    params.ctypes.data, stream)
        check(rc, "fused_chain_kernel")
        count_launch(fused_chain_kernel)
    return out


fused_chain_kernel.launches = 0
