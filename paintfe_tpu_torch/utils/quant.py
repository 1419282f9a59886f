"""Quantization helpers matching the reference's u8 semantics.

Effects round half up (``floor(v + 0.5)``, clipped), the compositor
truncates (a saturating ``as u8``).  Divides are plain IEEE ``/``: the JAX
package's Newton-refined ``exact_div`` works around the TPU's divide and
XLA's reciprocal rewrite, neither of which a correctly rounded divide
needs.  One PyTorch trap remains and is handled by ``ieee_div``.
"""

from __future__ import annotations

import numpy as np
import torch


def ieee_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a correctly rounded f32 divide on every device.

    PyTorch's CUDA divide turns a division by a host scalar into a multiply
    by its reciprocal (1 ulp off for most divisors); a divisor tensor on the
    same device keeps the true divide.  The divisor is filled on the device
    (``torch.full``): ``torch.tensor(c, device=...)`` would copy it from the
    host and wait for the stream, once a call."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt on every device: torch's CPU sqrt is not
    (sqrt(129/255) comes out 1 ulp low), an f64 sqrt rounded once to f32
    is."""
    return torch.sqrt(x.double()).float()


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half up, clamp to [0, 255], cast to u8 (Rust
    ``v.round().clamp(0, 255) as u8`` for finite v)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def round_half_away(x):
    """Rust ``f32::round`` (half away from zero) of an f32 tensor or numpy
    array, in f32."""
    xp = torch if isinstance(x, torch.Tensor) else np
    return xp.sign(x) * xp.floor(xp.abs(x) + 0.5)


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 255] then truncate toward zero (Rust saturating
    ``as u8``)."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)
