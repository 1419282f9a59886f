"""NeuQuant RGBA palette quantization for GIF export (the port of
paintfe_tpu.io.neuquant).

The reference's GIF encoder builds its palettes with the color_quant
crate's NeuQuant (src/io.rs:2960-2989: `NeuQuant::new(10, colors, rgba)`
then `index_of` per pixel).  `quantize_rgba` trains with the port's C++
(native/neuquant.cpp, the JAX package's trainer): the sample walk is
sequential, about a second a 1920x1080 frame there against tens of seconds
a 4K frame in numpy.  A failed g++ build raises.  The numpy trainer
(`quantize_rgba_plain`) is the plain version the tests hold the native one
against; both give the JAX package's palette and indices.

`quantize_rgba(frame, colors)` mirrors the reference fn of the same name:
returns (palette [colors, 3] u8, indices [H*W] u8).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SAMPLEFAC = 10  # the reference hard-codes NeuQuant::new(10, ...)

_CYCLES = 100
_PRIMES = (499, 491, 487, 503)
_BETA = 1.0 / 1024.0
_BETAGAMMA = 1.0  # beta * gamma with gamma = 1024


def _train_python(pixels: np.ndarray, samplefac: int,
                  colors: int) -> np.ndarray:
    """The NeuQuant training loop in numpy; returns the [colors, 4] u8
    colormap, green-sorted."""
    n = pixels.shape[0]
    idx = np.arange(colors, dtype=np.float64)
    net = np.repeat((idx * 256.0 / colors)[:, None], 4, axis=1)
    net[:, 3] = np.where(idx < 16, idx * 16.0, 255.0)  # dark-alpha ramp
    freq = np.full(colors, 1.0 / colors)
    bias = np.zeros(colors)

    samplepixels = max(n // samplefac, 1)
    delta = max(samplepixels // _CYCLES, 1)
    bias_radius = (colors // 8) << 6
    alpha_int = 1 << 10
    alphadec = 30 + (samplefac - 1) // 3
    rad = bias_radius >> 6
    if rad <= 1:
        rad = 0
    step = next((p for p in _PRIMES if n % p), _PRIMES[3])

    px = pixels.astype(np.float64)
    pos = 0
    for i in range(1, samplepixels + 1):
        p = px[pos]
        dist = np.abs(net - p).sum(axis=1)
        bestpos = int(np.argmin(dist))
        j = int(np.argmin(dist - bias))
        freq -= _BETA * freq
        bias += _BETAGAMMA * freq
        freq[bestpos] += _BETA
        bias[bestpos] -= _BETAGAMMA
        alpha = alpha_int / 1024.0
        net[j] -= alpha * (net[j] - p)
        if rad > 0:
            lo = max(j - rad + 1, 0)
            hi = min(j + rad, colors)
            d = np.abs(np.arange(lo, hi) - j).astype(np.float64)
            a = alpha * (rad * rad - d * d) / (rad * rad)
            a[d == 0] = 0.0  # the winner was already moved at full alpha
            net[lo:hi] -= a[:, None] * (net[lo:hi] - p)
        pos += step
        while pos >= n:
            pos -= n
        if i % delta == 0:
            alpha_int -= alpha_int // alphadec
            bias_radius -= bias_radius // 30
            rad = bias_radius >> 6
            if rad <= 1:
                rad = 0
    # half away from zero (clamped to [0, 255] first, where floor(x + 0.5)
    # is half-away), then green-sorted like color_quant's inxbuild: the
    # reference's palette order is the sorted network
    cmap = np.floor(np.clip(net, 0, 255) + 0.5).astype(np.uint8)
    return cmap[np.argsort(cmap[:, 1], kind="stable")]


def quantize_rgba(frame: np.ndarray,
                  colors: int) -> Tuple[np.ndarray, np.ndarray]:
    """frame: u8 [H, W, 4] -> (palette [colors, 3] u8, indices [H*W] u8).

    Trains on RGBA (alpha participates in the distance like color_quant)
    but returns an RGB palette, exactly as io.rs:2968-2979 does."""
    import ctypes

    from paintfe_tpu_torch import native

    colors = int(np.clip(colors, 2, 256))
    flat = np.ascontiguousarray(frame, np.uint8).reshape(-1, 4)
    n = flat.shape[0]
    lib = native.load()  # a failed build raises with g++'s message
    pal = np.zeros((colors, 4), np.uint8)
    indices = np.zeros(n, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.neuquant_quantize(flat.ctypes.data_as(u8p), n, SAMPLEFAC, colors,
                               pal.ctypes.data_as(u8p), indices.ctypes.data_as(u8p))
    if rc != 0:
        raise ValueError(f"neuquant_quantize refused {n} pixels at {colors} colors (rc {rc})")
    return pal[:, :3].copy(), indices


def quantize_rgba_plain(frame: np.ndarray,
                        colors: int) -> Tuple[np.ndarray, np.ndarray]:
    """quantize_rgba with the numpy trainer: the plain version of
    native/neuquant.cpp."""
    colors = int(np.clip(colors, 2, 256))
    flat = np.ascontiguousarray(frame, np.uint8).reshape(-1, 4)
    n = flat.shape[0]
    cmap = _train_python(flat, SAMPLEFAC, colors)
    # nearest palette entry, Manhattan over RGBA, first index wins —
    # chunked so a 4K frame doesn't materialize an 8.3M x 256 array
    indices = np.empty(n, np.uint8)
    ci = cmap.astype(np.int32)
    for lo in range(0, n, 1 << 16):
        chunk = flat[lo:lo + (1 << 16)].astype(np.int32)
        d = np.abs(chunk[:, None, :] - ci[None, :, :]).sum(axis=2)
        indices[lo:lo + (1 << 16)] = np.argmin(d, axis=1).astype(np.uint8)
    return cmap[:, :3].copy(), indices
