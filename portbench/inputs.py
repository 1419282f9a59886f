"""Inputs made from --seed: per-request draws and layered documents made
on the card."""

from __future__ import annotations

import numpy as np
import torch


def rng(seed: int, index: int = None) -> np.random.Generator:
    """A generator for the seed, or for request `index` of it (warm-up
    requests take negative indices); the same seed gives the same draws."""
    key = [int(seed)] if index is None else [int(seed), 0 if index >= 0 else 1, abs(int(index))]
    return np.random.default_rng(np.random.SeedSequence(key))


def device_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def layered_document(config: dict, device: torch.device, seed: int):
    """u8 [L, H, W, 4] layers of noise made on `device` from the seed, one
    a blend mode of config["blend_modes"], each opaque inside a rectangle
    and clear outside.  The rectangles are the configuration's, the same
    for every seed (their shapes and overlaps change the flatten's time by
    up to 13% between seeds): layer k's share of the canvas is the
    (7k mod L)-th of L shares evenly spaced over config["alpha_coverage"],
    its width and place follow fixed low-discrepancy fractions of k.
    Returns (layers, covered): covered[k], the pixels of layer k whose
    alpha is not 0."""
    h, w = config["height"], config["width"]
    n = len(config["blend_modes"])
    layers = torch.randint(0, 256, (n, h, w, 4), generator=device_generator(seed, device),
                           dtype=torch.uint8, device=device)
    layers[..., 3] = 0
    lo, hi = config["alpha_coverage"]
    shares = np.linspace(lo, hi, n)[[(7 * k) % n for k in range(n)]]
    covered = []
    for k, share in enumerate(shares):
        fw = share + (1.0 - share) * ((k * 0.6180339887) % 1.0)
        rw = max(1, min(w, round(fw * w)))
        rh = max(1, min(h, round(share * h * w / rw)))
        y0 = int(((k * 0.7548776662) % 1.0) * (h - rh))
        x0 = int(((k * 0.5698402910) % 1.0) * (w - rw))
        layers[k, y0:y0 + rh, x0:x0 + rw, 3] = 255
        covered.append(rh * rw)
    return layers, covered

