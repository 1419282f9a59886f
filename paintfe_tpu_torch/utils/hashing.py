"""Deterministic coordinate-hash noise, on the host in numpy
(paintfe_tpu.utils.hashing counterpart).

Behavioral contract: src/ops/effects.rs:144-162 (hash_u32 3-round
avalanche, hash_f32 in [0, 1)), src/ops/effects/noise.rs:53-71
(quintic-fade value noise), src/ops/effects/distort.rs:229-246
(multi-octave turbulence).

Every field these make depends only on coordinates and a seed, never on
pixel values, so the port builds them on the host, where np.uint32 wraps
exactly, and uploads the f32 result (torch has almost no uint32
arithmetic).  The f32 steps keep the JAX package's expression order, so
the fields are bit-identical to it.
"""

from __future__ import annotations

import numpy as np

_U = np.uint32
f32 = np.float32


def _u32(x) -> np.ndarray:
    # wrap like a jnp.uint32 cast: negative coordinates go modulo 2^32
    return np.asarray(np.asarray(x).astype(np.int64) & 0xFFFFFFFF, _U)


def hash_u32(x) -> np.ndarray:
    x = _u32(x)
    with np.errstate(over="ignore"):
        x = x * _U(0x9E3779B9)
        x = x ^ (x >> _U(16))
        x = x * _U(0x85EBCA6B)
        x = x ^ (x >> _U(13))
        x = x * _U(0xC2B2AE35)
        x = x ^ (x >> _U(16))
    return x


def hash_f32(x, y, seed) -> np.ndarray:
    """Coordinate hash -> f32 in [0, 1) with 24 bits of mantissa."""
    with np.errstate(over="ignore"):
        h = hash_u32(_u32(x) * _U(374761393) + _u32(y) * _U(668265263) + _u32(seed))
    return (h & _U(0x00FFFFFF)).astype(f32) / f32(16777216.0)


def perlin_noise_2d(x, y, seed) -> np.ndarray:
    """Quintic-fade value noise on the integer lattice; f32 in [0, 1]."""
    x = np.asarray(x, f32)
    y = np.asarray(y, f32)
    xi = np.floor(x).astype(np.int32)
    yi = np.floor(y).astype(np.int32)
    xf = x - xi.astype(f32)
    yf = y - yi.astype(f32)

    def fade(t):
        return t * t * t * (t * (t * f32(6.0) - f32(15.0)) + f32(10.0))

    u = fade(xf)
    v = fade(yf)

    n00 = hash_f32(xi, yi, seed)
    n10 = hash_f32(xi + 1, yi, seed)
    n01 = hash_f32(xi, yi + 1, seed)
    n11 = hash_f32(xi + 1, yi + 1, seed)

    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return nx0 + v * (nx1 - nx0)


def turbulence_2d(x, y, seed, octaves: int, roughness: float) -> np.ndarray:
    """Octave sum of value noise; amplitude *= roughness, frequency *= 2,
    divided (a true divide) by the sum of the amplitudes."""
    octaves = max(int(octaves), 1)
    x = np.asarray(x, f32)
    y = np.asarray(y, f32)
    total = np.zeros(np.broadcast_shapes(x.shape, y.shape), f32)
    amplitude = f32(1.0)
    frequency = f32(1.0)
    max_amplitude = f32(0.0)
    for i in range(octaves):
        s = (int(_u32(seed)) + i * 1000) & 0xFFFFFFFF
        total = total + perlin_noise_2d(x * frequency, y * frequency, s) * amplitude
        max_amplitude = f32(max_amplitude + amplitude)
        amplitude = f32(amplitude * f32(roughness))
        frequency = f32(frequency * f32(2.0))
    return total / max_amplitude
