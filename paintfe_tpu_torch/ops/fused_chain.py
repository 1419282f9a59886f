"""The headline filter chain: Gaussian blur, brightness/contrast, levels,
sepia with strength, then a soft-light flatten of an overlay.

Counterpart of paintfe_tpu/ops/fused_chain.py.  `fused_chain` is the plain
version, composed from the port's public ops; `fused_chain_kernel` runs the
whole chain in one hand-written CUDA kernel (K-chain, csrc/fused_chain.cu)
for a CUDA tensor and takes the plain version for a CPU tensor.  Both give
the bytes of chaining the script-level ops.
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.core.blend import BlendMode, blend_u8, clip_opacity
from paintfe_tpu_torch.ops.filters import gaussian_kernel
from paintfe_tpu_torch.ops.kernels import (check_rgba_u8, gaussian_blur_fused,
                                           gaussian_blur_plain, tile_rows)
from paintfe_tpu_torch.parallel.pipeline import (_bc_device, _levels_device,
                                                 _sepia_device, bc_factor,
                                                 levels_lut)

f32 = np.float32

_LUT_SMEM = 256  # shared memory of the kernel's levels table (kLutBytes)


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


def _tail_params(brightness, contrast, sepia_strength, blend_opacity):
    """The five f32 scalars of the kernel's pointwise tail, computed as the
    JAX package's _make_chain_kernel does."""
    sep_s = f32(np.clip(sepia_strength, 0.0, 1.0))
    return np.array([f32(brightness), bc_factor(contrast), sep_s,
                     f32(1.0) - sep_s, clip_opacity(blend_opacity)], f32)


def fused_chain_kernel(img, overlay, *, sigma=2.0, brightness=10.0,
                       contrast=20.0, black=10.0, white=245.0, gamma=1.1,
                       sepia_strength=0.5, blend_opacity=0.6):
    """One-kernel version of fused_chain (soft-light flatten only);
    bit-identical to it.  Counts its launches in
    `fused_chain_kernel.launches`."""
    if img.device.type == "cpu" and overlay.device.type == "cpu":
        return fused_chain(img, overlay, sigma=sigma, brightness=brightness,
                           contrast=contrast, black=black, white=white,
                           gamma=gamma, sepia_strength=sepia_strength,
                           blend_opacity=blend_opacity)
    check_rgba_u8(img, "fused_chain_kernel", ndims=(3,))
    check_rgba_u8(overlay, "fused_chain_kernel overlay", ndims=(3,))
    if overlay.shape != img.shape or overlay.device != img.device:
        raise ValueError("fused_chain_kernel: overlay must match the image's "
                         "shape and device")
    from paintfe_tpu_torch.utils.cuda_build import check, load_library

    taps = gaussian_kernel(float(sigma))
    nt = len(taps)
    r = nt // 2
    h, w = img.shape[:2]
    params = _tail_params(brightness, contrast, sepia_strength, blend_opacity)
    lut = levels_lut(black, white, gamma)
    out = torch.empty_like(img)
    if h * w == 0:
        return out
    lib = load_library()
    th = tile_rows(r, _LUT_SMEM)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        if th:
            rc = lib.pfe_chain_tiled(img.data_ptr(), overlay.data_ptr(),
                                     out.data_ptr(), h, w, taps.ctypes.data, nt,
                                     th, params.ctypes.data, lut.ctypes.data,
                                     stream)
        else:
            # the halo does not fit shared memory: K-blur, then the tail
            blurred = gaussian_blur_fused(img, sigma)
            rc = lib.pfe_chain_tail(blurred.data_ptr(), overlay.data_ptr(),
                                    out.data_ptr(), h, w, params.ctypes.data,
                                    lut.ctypes.data, stream)
    check(rc, "fused_chain_kernel")
    fused_chain_kernel.launches += 1
    return out


fused_chain_kernel.launches = 0
