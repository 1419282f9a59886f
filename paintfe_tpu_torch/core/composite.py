"""Layer-stack flattening, the compositor (paintfe_tpu.core.composite
counterpart).

Behavioral contract: `CanvasState::composite_viewport`
(src/canvas/canvas_state.rs:482-698): fold visible layers bottom-up over a
transparent background with `blend_pixel_static`; live masks are
alpha-encoded *conceal* values that scale the layer alpha with u32 integer
math.  On a CUDA tensor the fold is K-composite (one launch per run of up
to 32 layers); on a CPU tensor it is its plain version.  Layers are a
[N, H, W, 4] u8 tensor or a sequence of [H, W, 4] u8 tensors on one
device; numpy arrays are taken on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from paintfe_tpu_torch.core.blend import blend_u8
from paintfe_tpu_torch.ops.kernels import (as_u8_tensor, composite_stack_kernel,
                                           host_values, layer_list)


def composite_stack_static(layers, modes, opacities, conceal=None, init=None):
    """Flatten a layer stack to one RGBA image.

    Args:
      layers: u8 [N, H, W, 4] (or a sequence of [H, W, 4]), bottom first.
      modes: N blend-mode ids (BlendMode values), host-known.
      opacities: N opacities (clipped to [0, 1] in f32).
      conceal: optional u8 [N, H, W] (or a sequence of [H, W] or None)
        layer-mask conceal values (0 = show).
      init: optional u8 [H, W, 4] starting accumulator (default transparent).

    Returns: u8 [H, W, 4] on the layers' device.
    """
    return composite_stack_kernel(layers, modes, opacities, conceal, init)


def composite_stack(layers, modes, opacities, visibles, conceal=None, init=None):
    """composite_stack_static with per-layer visibility.  An invisible layer
    leaves the accumulator as it is, so it is dropped on the host before the
    fold; `modes`, `opacities` and `visibles` are read on the host."""
    layers = layer_list(layers)
    keep = [i for i, v in enumerate(host_values(visibles, bool)) if v]
    if not keep:
        return as_u8_tensor(init) if init is not None else torch.zeros_like(layers[0])
    modes = host_values(modes, np.int64)
    opacities = host_values(opacities, np.float32)
    masks = None if conceal is None else [layer_list(conceal)[i] for i in keep]
    return composite_stack_kernel([layers[i] for i in keep], [modes[i] for i in keep],
                                  [opacities[i] for i in keep], masks, init)


def composite_pair(base, top, mode, opacity):
    """Blend one layer over another (thin alias of blend_u8 for API parity)."""
    return blend_u8(base, top, mode, opacity)
