"""Effect pipelines: a script's apply_* chain, traced once and run over a
batch split over a device mesh (paintfe_tpu.parallel.pipeline
counterpart).

Scripts that never read individual pixels are pure op chains: record the
op sequence once, compose it into one image->image function, and run it
on a [N, H, W, 4] batch tensor on each mesh entry (the batch dimension
is written out; the JAX package vmaps).  _OP_TABLE holds the JAX
package's ops, name for name; a trace that meets any other host function
that touches pixels or the canvas (get_pixel, resize_image, ...) bails
with NotVectorizable and the caller runs the script per image.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paintfe_tpu_torch.ops import filters
from paintfe_tpu_torch.ops import transform as tfm
from paintfe_tpu_torch.ops.effects import artistic, distort, stylize
from paintfe_tpu_torch.ops.effects import noise as noise_mod

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class PipelineOp:
    name: str
    params: tuple


class NotVectorizable(Exception):
    """Raised when a script touches pixels directly and must run per-image."""


def _sepia_device(img, strength=None):
    """Script-sepia (truncating cast) on device (scripting.rs:900-938)."""
    f = img.float()
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    sr = torch.clamp(r * 0.393 + g * 0.769 + b * 0.189, max=255.0)
    sg = torch.clamp(r * 0.349 + g * 0.686 + b * 0.168, max=255.0)
    sb = torch.clamp(r * 0.272 + g * 0.534 + b * 0.131, max=255.0)
    if strength is not None:
        s = f32(np.clip(strength, 0.0, 1.0))
        inv, s = float(f32(1.0) - s), float(s)
        sr, sg, sb = r * inv + sr * s, g * inv + sg * s, b * inv + sb * s
    out = torch.stack([sr, sg, sb], dim=-1).to(torch.uint8)
    return torch.cat([out, img[..., 3:4]], dim=-1)


def bc_factor(contrast) -> np.float32:
    """The brightness/contrast gain, in f32 (scripting.rs:963-993)."""
    c = f32(contrast)
    return (f32(259.0) * (c + f32(255.0))) / (f32(255.0) * (f32(259.0) - c))


def _bc_device(img, brightness, contrast):
    factor = float(bc_factor(contrast))
    f = img[..., 0:3].float()
    rgb = torch.clamp(factor * (f + float(f32(brightness)) - 128.0) + 128.0,
                      0.0, 255.0)
    return torch.cat([rgb.to(torch.uint8), img[..., 3:4]], dim=-1)


def exposure_gain(ev) -> np.float32:
    """Script-exposure's gain 2^ev (scripting.rs), correctly rounded to f32:
    an f64 libm pow of the f32 ev, rounded once.  Both of the port's paths
    use it.  (The JAX package takes numpy's f32 power per image and XLA's
    exp2 in its batch path; the two parted on 271 of 801 ev values in
    [-4, 4] and never on a u8 output: ROADMAP C6.)"""
    return f32(math.pow(2.0, float(f32(ev))))


def _exposure_device(img, ev):
    f = img[..., 0:3].float()
    rgb = torch.clamp(f * float(exposure_gain(ev)), 0.0, 255.0)
    return torch.cat([rgb.to(torch.uint8), img[..., 3:4]], dim=-1)


def _desaturate_device(img):
    """Script-desaturate: integer BT.601 (scripting.rs:883-897)."""
    p = img.int()
    lum = ((p[..., 0] * 299 + p[..., 1] * 587 + p[..., 2] * 114) // 1000).to(torch.uint8)
    return torch.stack([lum, lum, lum, img[..., 3]], dim=-1)


def levels_lut(black, white, gamma) -> np.ndarray:
    """Script-levels as a 256-entry u8 table (scripting.rs:1054-1075): f32
    math with the power correctly rounded to f32.

    Levels only ever sees integer inputs, so the table is exact, where an
    in-kernel powf would not be correctly rounded.  The power is an f64
    libm pow rounded once to f32: numpy's f32 array power takes a SIMD
    path on AVX-512 hosts that is 1 ulp off on some inputs (0.36 ** 0.5),
    which would make the table depend on the host."""
    in_black = f32(black)
    in_range = np.maximum(f32(white) - in_black, f32(1.0))
    inv_gamma = float(f32(1.0) / np.maximum(f32(gamma), f32(0.01)))
    i = np.arange(256, dtype=f32)
    normalized = np.clip((i - in_black) / in_range, 0.0, 1.0)
    powed = np.array([math.pow(float(x), inv_gamma) for x in normalized], f32)
    return np.clip(powed * f32(255.0), 0.0, 255.0).astype(np.uint8)


def _levels_device(img, black, white, gamma):
    lut = torch.from_numpy(levels_lut(black, white, gamma)).to(img.device)
    return torch.cat([lut[img[..., 0:3].long()], img[..., 3:4]], dim=-1)


def _invert_device(img):
    return torch.cat([255 - img[..., 0:3], img[..., 3:4]], dim=-1)


# op name -> fn(img, *params) -> img, on u8 [..., H, W, 4] tensors; the
# constants (seed 42, sharpen radius 1, reduce-noise radius 2, 20 oil
# levels, halftone at 45 degrees) are the JAX package's
_OP_TABLE = {
    "apply_blur": lambda img, sigma: filters.gaussian_blur(img, sigma),
    "apply_box_blur": lambda img, r: filters.box_blur(img, float(r)),
    "apply_motion_blur": lambda img, a, d: filters.motion_blur(img, a, d),
    "apply_sharpen": lambda img, amount: filters.sharpen(img, amount, 1.0),
    "apply_reduce_noise": lambda img, s: filters.reduce_noise(img, s, 2),
    "apply_median": lambda img, r: filters.median(img, r),
    "apply_invert": _invert_device,
    "apply_desaturate": _desaturate_device,
    "apply_sepia": lambda img, *s: _sepia_device(img, *s),
    "apply_brightness_contrast": lambda img, b, c: _bc_device(img, b, c),
    "apply_exposure": _exposure_device,
    "apply_levels": lambda img, b, w, g: _levels_device(img, b, w, g),
    "apply_noise": lambda img, amount, mono: noise_mod.add_noise(
        img, amount, noise_mod.NoiseType.GAUSSIAN, bool(mono), 42, 1.0, 1),
    "apply_pixelate": lambda img, size: distort.pixelate(img, max(int(size), 1)),
    "apply_crystallize": lambda img, size: distort.crystallize(
        img, float(max(int(size), 1)), 42),
    "apply_bulge": lambda img, amount: distort.bulge(img, amount),
    "apply_twist": lambda img, angle: distort.twist(img, angle),
    "apply_glow": lambda img, r, i: filters.glow(img, r, i),
    "apply_vignette": lambda img, s, soft: stylize.vignette(img, s, soft),
    "apply_halftone": lambda img, dot: stylize.halftone(img, dot, 45.0),
    "apply_ink": lambda img, s, t: artistic.ink(img, s, t),
    "apply_oil_painting": lambda img, r: artistic.oil_painting(img, max(int(r), 1), 20),
    "flip_horizontal": tfm.flip_horizontal,
    "flip_vertical": tfm.flip_vertical,
    "rotate_180": tfm.rotate_180,
}


# Per-op argument conversion matching the host API's validators exactly,
# so the traced batch path accepts and rejects the same arguments as the
# per-image interpreter.
def _build_arg_specs():
    from paintfe_tpu_torch.scripting.api import _as_float, _as_int

    def int_min1(v):
        return max(_as_int(v), 1)

    def int_min1_f(v):
        return float(max(_as_int(v), 1))

    def int_f(v):
        return float(_as_int(v))

    def passthrough(v):
        return v

    return {
        "apply_blur": (_as_float,),
        "apply_box_blur": (int_f,),
        "apply_motion_blur": (_as_float, _as_float),
        "apply_sharpen": (_as_float,),
        "apply_reduce_noise": (_as_float,),
        "apply_median": (int_min1,),
        "apply_sepia": (_as_float,),
        "apply_brightness_contrast": (_as_float, _as_float),
        "apply_exposure": (_as_float,),
        "apply_levels": (_as_float, _as_float, _as_float),
        "apply_noise": (_as_float, passthrough),
        "apply_pixelate": (int_min1,),
        "apply_crystallize": (int_min1_f,),
        "apply_bulge": (_as_float,),
        "apply_twist": (_as_float,),
        "apply_glow": (_as_float, _as_float),
        "apply_vignette": (_as_float, _as_float),
        "apply_halftone": (_as_float,),
        "apply_ink": (_as_float, _as_float),
        "apply_oil_painting": (int_min1,),
    }


def trace_script(source: str, dims: Optional[Tuple[int, int]] = None
                 ) -> List[PipelineOp]:
    """Record a script's op chain by running it against a recording context.

    Only works for scripts that are pure op chains (no pixel reads, no
    selections, no RNG-dependent flow).  Raises NotVectorizable otherwise.

    `dims` = (width, height) reported by the script's width()/height()
    calls.  When None, those calls raise NotVectorizable("width"/"height"),
    and callers re-trace per shape bucket with the bucket's real dims.
    """
    import inspect

    from paintfe_tpu_torch.scripting.api import ScriptContext, build_host_fns
    from paintfe_tpu_torch.scripting.interp import (
        UNIT, Interpreter, RhaiRuntimeError, _type_of)

    ops: List[PipelineOp] = []
    # a recording context: it runs no op, so it needs no card
    ctx = ScriptContext(np.zeros((1, 1, 4), np.uint8), 1, 1, None, rng_seed=0,
                        device="cpu")
    interp_ref = {}
    fns = build_host_fns(ctx, interp_ref)
    arg_specs = _build_arg_specs()

    recorded = {}
    for name in fns:
        if name in _OP_TABLE:
            def make(name=name):
                spec = arg_specs.get(name)

                def rec(*args, _host_fn=fns[name]):
                    if spec is not None:
                        # arity parity with the per-image path: bind
                        # against the real host fn (apply_sepia() is legal,
                        # apply_levels(a, b) is not)
                        try:
                            inspect.signature(_host_fn).bind(*args)
                        except TypeError:
                            sig = ", ".join(_type_of(a) for a in args)
                            raise RhaiRuntimeError(
                                f"function not found: {name} ({sig})")
                        args = tuple(conv(a) for conv, a in zip(spec, args))
                    else:
                        args = tuple(
                            float(a) if isinstance(a, (int, float))
                            and not isinstance(a, bool) else a for a in args)
                    ops.append(PipelineOp(name, args))
                    return UNIT
                return rec
            recorded[name] = make()
        elif name in ("width", "height"):
            def make_dim(name=name):
                def dim():
                    if dims is None:
                        raise NotVectorizable(name)
                    return dims[0] if name == "width" else dims[1]
                return dim
            recorded[name] = make_dim()
        elif name in ("print", "print_line", "progress", "sleep", "PI",
                      "clamp", "clamp_f", "lerp", "distance", "abs", "min", "max",
                      "floor", "ceil", "round", "sqrt", "pow", "sin", "cos", "tan",
                      "atan2", "rgb_to_hsl", "hsl_to_rgb"):
            recorded[name] = fns[name]
        else:
            def make_bail(name=name):
                def bail(*args):
                    raise NotVectorizable(name)
                return bail
            recorded[name] = make_bail(name)

    interp = Interpreter(recorded)
    interp_ref["interp"] = interp
    interp.run(source)
    return ops


def from_jax_ops(ops) -> List[PipelineOp]:
    """The JAX package's PipelineOp list (name plus params tuple) as the
    port's; raises NotVectorizable for a name outside _OP_TABLE."""
    out = []
    for op in ops:
        if op.name not in _OP_TABLE:
            raise NotVectorizable(op.name)
        out.append(PipelineOp(op.name, tuple(op.params)))
    return out


def compile_pipeline(ops: Sequence[PipelineOp]) -> Callable:
    """Compose the op chain into one image->image function."""

    def run(img):
        for op in ops:
            img = _OP_TABLE[op.name](img, *op.params)
        return img

    return run


def run_batch(images, ops: Sequence[PipelineOp], mesh=None) -> np.ndarray:
    """Apply an op chain to a u8 [N, H, W, 4] batch (numpy or tensor),
    split over the mesh's 'batch' axis; returns the processed batch as a
    numpy array.

    N is padded with zero frames to a multiple of the mesh size; each
    entry runs the chain on its contiguous slice on its device (queued
    on every entry before any result is read, so distinct cards overlap),
    and the slices are gathered in order.  `mesh` may also be a device
    (parallel.mesh.as_mesh: "cuda" and None are this process's cards).
    The images never interact, so no entry reads another's slice: the
    path copies no halo."""
    from paintfe_tpu_torch.parallel.mesh import as_mesh, batch_sharding, pad_batch

    mesh = as_mesh(mesh)
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
    n = images.shape[0]
    pad = pad_batch(n, mesh) - n
    if pad:
        images = torch.cat([images, images.new_zeros((pad,) + images.shape[1:])])
    chain = compile_pipeline(ops)
    outs = [chain(block) for block in batch_sharding(mesh).place(images).flat]
    outs = [o.cpu() for o in outs]
    return (outs[0] if len(outs) == 1 else torch.cat(outs))[:n].numpy()
