"""Host API surface for scripts — the contract of scripting.rs:318-1482
(paintfe_tpu.scripting.api counterpart).

Canvas/pixel access, the apply_* effect functions, layer/canvas transforms
with CanvasOpRequest replay, utilities (math, RNG, color conversion) and
the selection API.  The pixel buffer stays a numpy array on the host;
the effect functions (apply_blur, apply_box_blur, ... apply_oil_painting)
run on the context's torch device, with the JAX package's argument
conversions and constants; resize_image and resize_canvas are host numpy,
as in the JAX package.

The script-only pointwise variants (apply_invert, apply_desaturate,
apply_sepia, apply_brightness_contrast, apply_hsl, apply_exposure,
apply_levels) intentionally differ from the menu adjustments — integer math
or truncating casts — and are reproduced here exactly (scripting.rs:869-1075).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from paintfe_tpu_torch.ops import filters
from paintfe_tpu_torch.ops import transform as tfm
from paintfe_tpu_torch.ops.effects import artistic, distort, stylize
from paintfe_tpu_torch.ops.effects import noise as noise_mod
from paintfe_tpu_torch.parallel.pipeline import exposure_gain, levels_lut
from paintfe_tpu_torch.scripting.interp import UNIT, Closure, RhaiRuntimeError, to_display
from paintfe_tpu_torch.utils.device import resolve_device

f32 = np.float32
U64_MASK = (1 << 64) - 1


@dataclasses.dataclass
class CanvasOpRequest:
    """Canvas-wide op queued for replay on the other layers
    (scripting.rs:42-58)."""

    kind: str  # flip_h, flip_v, rot90cw, rot90ccw, rot180, resize_image, resize_canvas
    w: int = 0
    h: int = 0
    filter: str = "bilinear"
    anchor: tuple = (0, 0)


# Host functions with no observable side effects — safe to call once on
# whole arrays instead of per pixel.  Everything else (rand_* which must
# advance the xorshift64 state per callback, print/progress/sleep, pixel
# and selection writes, apply_* effects, script-defined fns) forces the
# scalar per-pixel path.
_PURE_HOST_FNS = frozenset({
    "width", "height", "is_selected", "has_selection",
    "get_pixel", "get_r", "get_g", "get_b", "get_a",
    "clamp", "clamp_f", "lerp", "distance",
    "abs", "min", "max", "abs_i", "min_i", "max_i", "min_f", "max_f",
    "floor", "ceil", "round", "sqrt", "pow", "sin", "cos", "tan", "atan2",
    "PI", "rgb_to_hsl", "hsl_to_rgb",
    # std math package (interp._STD_HOST_FNS): pure, array-capable
    "exp", "ln", "log", "hypot", "atan", "sinh", "cosh", "tanh",
    "asin", "acos", "asinh", "acosh", "atanh", "E",
})

# Std array methods that invoke a function-valued argument (closure or Fn
# pointer).  With an argument present, the callee is arbitrary code: the
# vectorizer purity scans must treat them like `.call()` indirection.
_HIGHER_ORDER_METHODS = frozenset({
    "map", "filter", "reduce", "for_each", "sort", "retain", "drain",
    "index_of", "find", "some", "all", "none",
    "reduce_rev", "find_map", "dedup",
})

_MUTATING_METHODS = frozenset({
    "push", "pop", "clear", "remove",
    # std array package methods that mutate the receiver
    "sort", "reverse", "retain", "drain", "splice", "insert", "shift",
    "chop", "append", "pad", "dedup", "split",
    # std map package mutators
    "set", "mixin", "fill_with",
    # in-place string methods (interp._STRING_INPLACE/_RET)
    "trim", "make_upper", "make_lower", "replace", "truncate",
    "crop",
})


def _base_var(node):
    """Innermost base of an index/property chain, or None."""
    while isinstance(node, tuple) and node[0] in ("index", "method"):
        node = node[1]
    if isinstance(node, tuple) and node[0] == "var":
        return node[1]
    return None


# Host functions that never read or write pixel/selection/canvas state.
# A closure restricted to these (plus captured-state writes, which only
# the loop below observes) cannot see the loop's own in-progress pixel
# stores, so its per-pixel args can come from a row snapshot and results
# can be written back in bulk — removing the per-pixel numpy indexing
# that dominates the scalar loop.
_NONPIXEL_HOST_FNS = frozenset({
    "width", "height", "is_selected", "has_selection",
    "clamp", "clamp_f", "lerp", "distance",
    "abs", "min", "max", "abs_i", "min_i", "max_i", "min_f", "max_f",
    "floor", "ceil", "round", "sqrt", "pow", "sin", "cos", "tan", "atan2",
    "PI", "rgb_to_hsl", "hsl_to_rgb",
    "rand_int", "rand_float", "print", "print_line", "debug", "progress",
})


def closure_avoids_pixel_state(cb: Closure, user_fns=frozenset()) -> bool:
    """True iff every call inside the body is provably one of the
    non-pixel host fns: no user fns (they may do anything), no shadowed
    names, no `.call()` methods (FnPtr/closure indirection), no nested
    closures.  Such a body may be impure (captured writes, RNG, console)
    but cannot observe ctx.pixels — the scalar loop may then batch its
    pixel reads/writes per region."""

    # any name bound anywhere in the body (params, lets, loop vars, fn
    # decls) may shadow a whitelisted host name with arbitrary behavior —
    # collect them all first, position-insensitively (conservative)
    loc = set(cb.params)
    stack = [cb.body]
    while stack:
        e = stack.pop()
        if isinstance(e, list):
            stack.extend(x for x in e if isinstance(x, (list, tuple)))
            continue
        if not isinstance(e, tuple):
            continue
        if e[0] in ("let", "const", "for", "fn") and len(e) > 1:
            if isinstance(e[1], str):
                loc.add(e[1])
            elif e[0] == "for" and isinstance(e[1], tuple):
                loc.update(e[1])  # two-binding `for (v, i) in`
        if e[0] == "try" and len(e) > 2 and isinstance(e[2], str):
            loc.add(e[2])  # catch variable
        stack.extend(x for x in e[1:] if isinstance(x, (list, tuple)))

    stack = [cb.body]
    while stack:
        e = stack.pop()
        if isinstance(e, list):
            stack.extend(x for x in e if isinstance(x, (list, tuple)))
            continue
        if not isinstance(e, tuple):
            continue
        kind = e[0]
        if kind == "call":
            if (e[1] in user_fns or e[1] not in _NONPIXEL_HOST_FNS
                    or e[1] in loc
                    or any(e[1] in s for s in cb.scope_chain)):
                return False
        elif kind == "closure":
            return False
        elif kind == "method" and len(e) > 3 and e[3] is not None \
                and (e[2] in ("call", "curry")
                     or (e[2] in _HIGHER_ORDER_METHODS and e[3])):
            return False
        stack.extend(x for x in e[1:] if isinstance(x, (list, tuple)))
    return True


def closure_is_pure(cb: Closure, user_fns=frozenset()) -> bool:
    """True iff evaluating the closure body can have no side effect
    observable outside the call: only whitelisted host calls (and never a
    script-defined function, which may shadow a host name and do
    anything), no nested closures, and writes only to names bound inside
    the body (params / `let` locals), in declaration order.  Index
    expressions of assignment targets are scanned too."""

    ok = True

    def scan_expr(e, loc):
        nonlocal ok
        if not ok or not isinstance(e, tuple):
            return
        kind = e[0]
        if kind == "call":
            # call_function (interp.py:368-375) resolves scope variables
            # BEFORE host fns: a let-bound closure shadowing a pure host
            # name (`let abs = |v| { log.push(v); v }`) would execute the
            # captured closure.  Any name bound in the captured scope
            # chain or declared locally so far is therefore unprovable.
            if (
                e[1] in user_fns
                or e[1] not in _PURE_HOST_FNS
                or e[1] in loc
                or any(e[1] in s for s in cb.scope_chain)
            ):
                ok = False
                return
            for a in e[2]:
                scan_expr(a, loc)
        elif kind == "closure":
            ok = False  # could capture and be called impurely later
        elif kind == "method":
            if e[3] is not None and e[2] in user_fns:
                ok = False  # fn-call syntax sugar may hit a script fn
                return
            if e[3] is not None and (
                    e[2] in ("call", "curry")
                    or (e[2] in _HIGHER_ORDER_METHODS and e[3])):
                # .call()/.curry() (and std array methods taking a
                # function argument) on a captured FnPtr/Closure can
                # execute arbitrary (impure) code — the vectorizer would
                # run it ONCE on whole arrays instead of once per pixel
                ok = False
                return
            if e[3] is not None and e[2] in _MUTATING_METHODS and _base_var(e[1]) not in loc:
                ok = False
                return
            scan_expr(e[1], loc)
            for a in (e[3] or ()):
                scan_expr(a, loc)
        elif kind == "if":
            scan_expr(e[1], loc)
            scan_block(e[2], loc)
            if e[3] is not None:
                scan_block(e[3], loc)
        elif kind == "block":
            scan_block(e, loc)
        elif kind == "switch":
            scan_expr(e[1], loc)
            for pats, guard, body in e[2]:
                for p in (pats or ()):
                    scan_expr(p, loc)
                if guard is not None:
                    scan_expr(guard, loc)
                (scan_block if body[0] == "block" else scan_expr)(body, loc)
            if e[3] is not None:
                (scan_block if e[3][0] == "block" else scan_expr)(e[3], loc)
        else:
            for part in e[1:]:
                if isinstance(part, tuple):
                    scan_expr(part, loc)
                elif isinstance(part, list):
                    for item in part:
                        scan_expr(item, loc)

    def scan_block(block, outer):
        nonlocal ok
        loc = set(outer)
        for st in block[1]:
            if not ok:
                return
            kind = st[0]
            if kind in ("let", "const"):
                scan_expr(st[2], loc)
                loc.add(st[1])
            elif kind == "assign":
                target = st[1]
                name = target[1] if target[0] == "var" else _base_var(target)
                if name not in loc:
                    ok = False  # write to captured state
                    return
                scan_expr(target, loc)  # index exprs can hide impure calls
                scan_expr(st[3], loc)
            elif kind == "expr":
                scan_expr(st[1], loc)
            elif kind in ("while", "dowhile"):
                scan_expr(st[1], loc)
                scan_block(st[2], loc)
            elif kind == "loop":
                scan_block(st[1], loc)
            elif kind == "for":
                scan_expr(st[2], loc)
                bound = set(st[1]) if isinstance(st[1], tuple) else {st[1]}
                scan_block(st[3], loc | bound)
            elif kind in ("break", "continue"):
                pass
            elif kind == "return":
                if st[1] is not None:
                    scan_expr(st[1], loc)
            else:
                ok = False  # fn defs or unknown statements: be conservative
                return

    scan_block(cb.body, set(cb.params))
    return ok


class ScriptContext:
    def __init__(self, pixels: np.ndarray, width: int, height: int,
                 mask: Optional[np.ndarray], rng_seed: Optional[int] = None,
                 device="cuda"):
        # torch device the effect functions run on; CUDA with no card raises
        self.device = resolve_device(device)
        self.pixels = np.asarray(pixels, np.uint8).reshape(height, width, 4).copy()
        self.width = width
        self.height = height
        # mask is [H, W] u8 (0 = unselected) or None = everything selected
        self.mask = None if mask is None else np.asarray(mask, np.uint8).reshape(height, width)
        self.console: List[str] = []
        self.canvas_ops: List[CanvasOpRequest] = []
        self.progress = 0.0
        if rng_seed is None:
            rng_seed = (time.time_ns() ^ 0x517CC1B727220A95) & U64_MASK
        self.rng_state = rng_seed & U64_MASK

    # -- helpers -------------------------------------------------------------

    def mask_or_none(self):
        return self.mask

    def xorshift64(self) -> int:
        s = self.rng_state
        s ^= (s << 13) & U64_MASK
        s ^= s >> 7
        s ^= (s << 17) & U64_MASK
        self.rng_state = s
        return s


def _as_int(v, what="argument"):
    # Rhai's typed dispatch never coerces FLOAT->INT: an i64-registered
    # host fn called with 1.0 is function-not-found in the reference
    # (register_fn |x: i64| ...), so integral floats are REJECTED too
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
        raise RhaiRuntimeError(f"{what} must be an integer")
    return int(v)


def _channel_or_old(v, old):
    """Rhai Dynamic::as_int().unwrap_or(old) (scripting.rs:466-471): only
    INT channel results commit (clamped 0..255); floats — even integral
    ones — bools, and anything else keep the old channel value."""
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return max(0, min(255, int(v)))
    return old


def _as_float(v):
    if isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool):
        return float(v)
    raise RhaiRuntimeError("argument must be a number")


def _as_float_strict(v):
    """f64-registered params: Rhai never coerces INT->FLOAT either, but
    the reference registers most numeric effect params as f64 AND scripts
    in its own corpus call them with INT literals via the i64 overloads
    it provides for utility math — the effect fns themselves are f64-only
    and the test corpus (tests/scripting.rs) consistently passes floats.
    _as_float (lenient) stays the default for ergonomics; strict variants
    can adopt this when a divergence is demonstrated against a reference
    probe."""
    if isinstance(v, (float, np.floating)):
        return float(v)
    raise RhaiRuntimeError("argument must be a float")


def build_host_fns(ctx: ScriptContext, interp_ref: dict) -> Dict[str, Any]:
    """Register every host function against `ctx`.  `interp_ref['interp']`
    is filled in by the engine so closures can be invoked."""

    fns: Dict[str, Any] = {}

    def register(name):
        def deco(f):
            fns[name] = f
            return f
        return deco

    def call_closure(cb, args):
        return interp_ref["interp"].call_closure(cb, args)

    # -- canvas info ---------------------------------------------------------

    register("width")(lambda: ctx.width)
    register("height")(lambda: ctx.height)

    @register("is_selected")
    def is_selected(x, y):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            for v in (x, y):
                if isinstance(v, np.ndarray) and v.dtype.kind not in "iu":
                    # the scalar oracle rejects non-integer coordinates;
                    # bail so the loop raises the exact error
                    raise RhaiRuntimeError("argument must be an integer")
            inb = (x >= 0) & (y >= 0) & (x < ctx.width) & (y < ctx.height)
            if ctx.mask is None:
                return inb
            sel = ctx.mask[np.clip(y, 0, ctx.height - 1), np.clip(x, 0, ctx.width - 1)] > 0
            return inb & sel
        x, y = _as_int(x), _as_int(y)
        if x < 0 or y < 0 or x >= ctx.width or y >= ctx.height:
            return False
        if ctx.mask is None:
            return True
        return bool(ctx.mask[y, x] > 0)

    # -- pixel access --------------------------------------------------------

    @register("get_pixel")
    def get_pixel(x, y):
        x, y = _as_int(x), _as_int(y)
        if x < 0 or y < 0 or x >= ctx.width or y >= ctx.height:
            return [0, 0, 0, 0]
        return [int(v) for v in ctx.pixels[y, x]]

    @register("set_pixel")
    def set_pixel(x, y, r, g, b, a):
        x, y = _as_int(x), _as_int(y)
        if x < 0 or y < 0 or x >= ctx.width or y >= ctx.height:
            return UNIT
        ctx.pixels[y, x] = [
            max(0, min(255, _as_int(v))) for v in (r, g, b, a)
        ]
        return UNIT

    for i, name in enumerate(["get_r", "get_g", "get_b", "get_a"]):
        def getter(x, y, _c=i):
            xi, yi = _as_int(x), _as_int(y)
            if xi < 0 or yi < 0 or xi >= ctx.width or yi >= ctx.height:
                return 0
            return int(ctx.pixels[yi, xi, _c])
        register(name)(getter)

    for i, name in enumerate(["set_r", "set_g", "set_b", "set_a"]):
        def setter(x, y, v, _c=i):
            xi, yi = _as_int(x), _as_int(y)
            if xi < 0 or yi < 0 or xi >= ctx.width or yi >= ctx.height:
                return UNIT
            ctx.pixels[yi, xi, _c] = max(0, min(255, _as_int(v)))
            return UNIT
        register(name)(setter)

    # -- bulk iteration -------------------------------------------------------

    def _bulk_apply(cb, xs, region=None):
        """Vectorized fast path: run the closure once on index/channel arrays.

        Attempted ONLY when a purity scan of the closure AST proves the
        body is side-effect free (no impure host calls, no writes to
        captured state) — otherwise the per-pixel interpreter loop runs,
        which advances the RNG and emits console/progress effects once per
        pixel exactly like the reference (scripting.rs:437-557,1217-1256).
        For a pure closure the try/except fallback is harmless: a failed
        vectorized attempt (e.g. array truthiness in data-dependent `if`)
        cannot have leaked any observable effect.

        SNAPSHOT semantics (scripting.rs:446-495): the reference clones the
        pixels, loops over the CLONE, and writes back only on success —
        get_pixel during the loop reads the ORIGINAL image, set_pixel
        writes during the loop are clobbered by the final writeback (but
        persist when the loop errors, since the writeback is skipped), and
        a mid-loop throw commits NOTHING to the canvas.  Channel values
        follow Dynamic::as_int().unwrap_or(old): only INTs commit (clamped
        0..255); floats/bools/anything else silently keep the old value."""
        y0, y1, x0, x1 = region if region else (0, ctx.height, 0, ctx.width)
        if closure_is_pure(cb, frozenset(interp_ref["interp"].user_fns)):
            px = ctx.pixels[y0:y1, x0:x1].astype(np.int64)
            try:
                args = []
                if xs:
                    gx = np.broadcast_to(np.arange(x0, x1, dtype=np.int64)[None, :],
                                         (y1 - y0, x1 - x0))
                    gy = np.broadcast_to(np.arange(y0, y1, dtype=np.int64)[:, None],
                                         (y1 - y0, x1 - x0))
                    args += [gx, gy]
                args += [px[..., 0], px[..., 1], px[..., 2], px[..., 3]]
                res = call_closure(cb, args)
                if res is UNIT:
                    return
                if isinstance(res, list) and len(res) >= 4:
                    chans = []
                    for c in res[:4]:
                        arr = np.broadcast_to(np.asarray(c), px.shape[:2])
                        if arr.dtype.kind not in "iu":
                            # per pixel the scalar loop KEEPS the old value
                            # for non-int results, but a merged array dtype
                            # cannot distinguish int-branch pixels from
                            # float-branch ones — bail to the exact loop
                            raise TypeError("non-int channel result")
                        chans.append(np.clip(arr, 0, 255))
                    out = np.stack(chans, axis=-1).astype(np.uint8)
                    ctx.pixels[y0:y1, x0:x1] = out
                    return
                return
            except Exception:
                pass  # fall through to scalar loop
        work = ctx.pixels.copy()  # the reference's whole-buffer clone
        if closure_avoids_pixel_state(cb,
                                      frozenset(interp_ref["interp"].user_fns)):
            # the body provably never reads/writes ctx.pixels, so the
            # loop's own stores are invisible to it: snapshot the region
            # once (tolist: C-speed, python ints) and write back in bulk,
            # removing the per-pixel numpy indexing that dominates the
            # scalar path (effects like console/RNG still fire per pixel
            # in order)
            from paintfe_tpu_torch.scripting.pycompile import get_closure_region_fn

            rows = work[y0:y1, x0:x1].tolist()
            region_fn = get_closure_region_fn(cb, interp_ref["interp"], xs)
            if region_fn is not None:
                # compiled region runner: the per-pixel loop itself
                # lives in generated code (one direct call per pixel)
                region_fn(interp_ref["interp"], rows, x0, y0)
            else:
                for yi, row in enumerate(rows):
                    y = y0 + yi
                    for xi, p in enumerate(row):
                        args = ([x0 + xi, y] if xs else []) + p
                        res = call_closure(cb, args)
                        if isinstance(res, list) and len(res) >= 4:
                            row[xi] = [_channel_or_old(v, o)
                                       for v, o in zip(res[:4], p)]
            # success-only writeback: a throw above skips it entirely
            work[y0:y1, x0:x1] = np.asarray(rows, np.uint8)
            ctx.pixels = work
            return
        for y in range(y0, y1):
            for x in range(x0, x1):
                p = work[y, x]
                old = [int(p[0]), int(p[1]), int(p[2]), int(p[3])]
                args = ([x, y] if xs else []) + old
                res = call_closure(cb, args)
                if isinstance(res, list) and len(res) >= 4:
                    work[y, x] = [_channel_or_old(v, o)
                                  for v, o in zip(res[:4], old)]
        ctx.pixels = work  # success-only writeback

    @register("for_each_pixel")
    def for_each_pixel(cb):
        if not isinstance(cb, Closure):
            raise RhaiRuntimeError("for_each_pixel expects a closure")
        _bulk_apply(cb, xs=True)
        return UNIT

    @register("for_region")
    def for_region(x, y, w, h, cb):
        if not isinstance(cb, Closure):
            raise RhaiRuntimeError("for_region expects a closure")
        x, y, w, h = _as_int(x), _as_int(y), _as_int(w), _as_int(h)
        # the reference computes x0 = rx.max(0) as u32 and the end as
        # ((rx+rw) as u32).min(w): `as u32` TRUNCATES, so a negative sum
        # wraps to a huge u32 and clamps to the full extent, and an
        # origin above u32::MAX wraps back down (scripting.rs:513-516) —
        # bug-for-bug parity on both
        x0 = max(x, 0) & 0xFFFFFFFF
        y0 = max(y, 0) & 0xFFFFFFFF
        x1 = min((x + w) & 0xFFFFFFFF, ctx.width)
        y1 = min((y + h) & 0xFFFFFFFF, ctx.height)
        if x1 <= x0 or y1 <= y0:
            return UNIT
        _bulk_apply(cb, xs=True, region=(y0, y1, x0, x1))
        return UNIT

    @register("map_channels")
    def map_channels(cb):
        if not isinstance(cb, Closure):
            raise RhaiRuntimeError("map_channels expects a closure")
        _bulk_apply(cb, xs=False)
        return UNIT

    # -- effect API (mask-aware, via ops modules) -----------------------------

    def _img(): return ctx.pixels

    def _set(img):
        ctx.pixels = np.ascontiguousarray(img, np.uint8)

    def _on_device():
        return torch.from_numpy(_img()).to(ctx.device)

    def _effect(op, *args):
        _set(op(_on_device(), *args, ctx.mask_or_none()).cpu().numpy())

    register("apply_blur")(lambda sigma: _set(filters.gaussian_blur_with_selection(
        _on_device(), _as_float(sigma), ctx.mask_or_none()).cpu().numpy()))
    register("apply_box_blur")(lambda r: _effect(
        filters.box_blur, float(_as_int(r))))
    register("apply_motion_blur")(lambda angle, dist: _effect(
        filters.motion_blur, _as_float(angle), _as_float(dist)))
    register("apply_sharpen")(lambda amount: _effect(
        filters.sharpen, _as_float(amount), 1.0))
    register("apply_reduce_noise")(lambda s: _effect(
        filters.reduce_noise, _as_float(s), 2))
    register("apply_median")(lambda r: _effect(filters.median, max(_as_int(r), 1)))
    register("apply_noise")(lambda amount, mono: _effect(
        noise_mod.add_noise, _as_float(amount), noise_mod.NoiseType.GAUSSIAN,
        bool(mono), 42, 1.0, 1))
    register("apply_pixelate")(lambda size: _effect(
        distort.pixelate, max(_as_int(size), 1)))
    register("apply_crystallize")(lambda size: _effect(
        distort.crystallize, float(max(_as_int(size), 1)), 42))
    register("apply_bulge")(lambda amount: _effect(
        distort.bulge, _as_float(amount), (0.5, 0.5)))
    register("apply_twist")(lambda angle: _effect(
        distort.twist, _as_float(angle), (0.5, 0.5)))
    register("apply_glow")(lambda r, i: _effect(
        filters.glow, _as_float(r), _as_float(i)))
    register("apply_vignette")(lambda s, soft: _effect(
        stylize.vignette, _as_float(s), _as_float(soft)))
    register("apply_halftone")(lambda dot: _effect(
        stylize.halftone, _as_float(dot), 45.0, stylize.HalftoneShape.CIRCLE))
    register("apply_ink")(lambda s, t: _effect(
        artistic.ink, _as_float(s), _as_float(t)))
    register("apply_oil_painting")(lambda r: _effect(
        artistic.oil_painting, max(_as_int(r), 1), 20))

    # -- script-only pointwise variants (exact per scripting.rs) --------------

    @register("apply_invert")
    def apply_invert():
        ctx.pixels[..., 0:3] = 255 - ctx.pixels[..., 0:3]
        return UNIT

    @register("apply_desaturate")
    def apply_desaturate():
        p = ctx.pixels.astype(np.uint32)
        gray = ((p[..., 0] * 299 + p[..., 1] * 587 + p[..., 2] * 114) // 1000).astype(np.uint8)
        ctx.pixels[..., 0] = gray
        ctx.pixels[..., 1] = gray
        ctx.pixels[..., 2] = gray
        return UNIT

    def _sepia_rgb(p):
        r = p[..., 0].astype(f32)
        g = p[..., 1].astype(f32)
        b = p[..., 2].astype(f32)
        sr = np.minimum(r * f32(0.393) + g * f32(0.769) + b * f32(0.189), f32(255.0))
        sg = np.minimum(r * f32(0.349) + g * f32(0.686) + b * f32(0.168), f32(255.0))
        sb = np.minimum(r * f32(0.272) + g * f32(0.534) + b * f32(0.131), f32(255.0))
        return r, g, b, sr, sg, sb

    @register("apply_sepia")
    def apply_sepia(strength=None):
        r, g, b, sr, sg, sb = _sepia_rgb(ctx.pixels)
        if strength is None:
            ctx.pixels[..., 0] = sr.astype(np.uint8)  # truncating cast
            ctx.pixels[..., 1] = sg.astype(np.uint8)
            ctx.pixels[..., 2] = sb.astype(np.uint8)
        else:
            s = f32(np.clip(_as_float(strength), 0.0, 1.0))
            inv = f32(1.0) - s
            ctx.pixels[..., 0] = (r * inv + sr * s).astype(np.uint8)
            ctx.pixels[..., 1] = (g * inv + sg * s).astype(np.uint8)
            ctx.pixels[..., 2] = (b * inv + sb * s).astype(np.uint8)
        return UNIT

    @register("apply_brightness_contrast")
    def apply_brightness_contrast(brightness, contrast):
        c = f32(_as_float(contrast))
        factor = (f32(259.0) * (c + f32(255.0))) / (f32(255.0) * (f32(259.0) - c))
        bright = f32(_as_float(brightness))
        for ch in range(3):
            v = ctx.pixels[..., ch].astype(f32)
            out = np.clip(factor * (v + bright - f32(128.0)) + f32(128.0), 0.0, 255.0)
            ctx.pixels[..., ch] = out.astype(np.uint8)  # truncating cast
        return UNIT

    @register("apply_hsl")
    def apply_hsl(hue, sat, light):
        hue_shift = f32(_as_float(hue))
        sat_factor = f32(1.0) + f32(_as_float(sat)) / f32(100.0)
        light_offset = f32(_as_float(light)) * f32(255.0) / f32(100.0)
        p = ctx.pixels
        r = p[..., 0].astype(f32) / f32(255.0)
        g = p[..., 1].astype(f32) / f32(255.0)
        b = p[..., 2].astype(f32) / f32(255.0)
        cmax = np.maximum(np.maximum(r, g), b)
        cmin = np.minimum(np.minimum(r, g), b)
        l = (cmax + cmin) / f32(2.0)
        d = cmax - cmin
        gray = np.abs(d) < 1e-10
        safe_d = np.where(gray, f32(1.0), d)
        s = np.where(
            gray, f32(0.0),
            np.where(l > 0.5, d / np.where(gray, 1, f32(2.0) - cmax - cmin),
                     d / np.where(gray, 1, cmax + cmin)),
        )
        hr = (g - b) / safe_d + np.where(g < b, f32(6.0), f32(0.0))
        hg = (b - r) / safe_d + f32(2.0)
        hb = (r - g) / safe_d + f32(4.0)
        h = np.where(
            np.abs(cmax - r) < 1e-10, hr,
            np.where(np.abs(cmax - g) < 1e-10, hg, hb),
        ) / f32(6.0)
        h = np.where(gray, f32(0.0), h)
        nh = h + hue_shift / f32(360.0)
        nh = nh - np.floor(nh)  # rem_euclid(1.0)
        ns = np.clip(s * sat_factor, 0.0, 1.0)
        q = np.where(l < 0.5, l * (f32(1.0) + ns), l + ns - l * ns)
        pq = f32(2.0) * l - q

        def hue2rgb(t):
            t = np.where(t < 0.0, t + f32(1.0), t)
            t = np.where(t > 1.0, t - f32(1.0), t)
            return np.where(
                t < 1.0 / 6.0, pq + (q - pq) * f32(6.0) * t,
                np.where(t < 0.5, q,
                         np.where(t < 2.0 / 3.0,
                                  pq + (q - pq) * (f32(2.0) / f32(3.0) - t) * f32(6.0), pq)),
            )

        achro = np.abs(ns) < 1e-10
        nr = np.where(achro, l, hue2rgb(nh + f32(1.0) / f32(3.0)))
        ng = np.where(achro, l, hue2rgb(nh))
        nb = np.where(achro, l, hue2rgb(nh - f32(1.0) / f32(3.0)))
        ctx.pixels[..., 0] = np.clip(nr * f32(255.0) + light_offset, 0.0, 255.0).astype(np.uint8)
        ctx.pixels[..., 1] = np.clip(ng * f32(255.0) + light_offset, 0.0, 255.0).astype(np.uint8)
        ctx.pixels[..., 2] = np.clip(nb * f32(255.0) + light_offset, 0.0, 255.0).astype(np.uint8)
        return UNIT

    @register("apply_exposure")
    def apply_exposure(ev):
        gain = exposure_gain(_as_float(ev))
        for ch in range(3):
            v = ctx.pixels[..., ch].astype(f32) * gain
            ctx.pixels[..., ch] = np.clip(v, 0.0, 255.0).astype(np.uint8)
        return UNIT

    @register("apply_levels")
    def apply_levels(black, white, gamma):
        lut = levels_lut(_as_float(black), _as_float(white), _as_float(gamma))
        ctx.pixels[..., 0:3] = lut[ctx.pixels[..., 0:3]]
        return UNIT

    # -- transforms -----------------------------------------------------------

    @register("flip_horizontal")
    def flip_horizontal():
        ctx.pixels = tfm.flip_horizontal(ctx.pixels)
        return UNIT

    @register("flip_vertical")
    def flip_vertical():
        ctx.pixels = tfm.flip_vertical(ctx.pixels)
        return UNIT

    @register("rotate_180")
    def rotate_180():
        ctx.pixels = tfm.rotate_180(ctx.pixels)
        return UNIT

    @register("flip_canvas_horizontal")
    def flip_canvas_horizontal():
        ctx.pixels = tfm.flip_horizontal(ctx.pixels)
        ctx.canvas_ops.append(CanvasOpRequest("flip_h"))
        return UNIT

    @register("flip_canvas_vertical")
    def flip_canvas_vertical():
        ctx.pixels = tfm.flip_vertical(ctx.pixels)
        ctx.canvas_ops.append(CanvasOpRequest("flip_v"))
        return UNIT

    @register("rotate_canvas_90cw")
    def rotate_canvas_90cw():
        ctx.pixels = tfm.rotate_90cw(ctx.pixels)
        ctx.width, ctx.height = ctx.height, ctx.width
        if ctx.mask is not None:
            # a dim swap leaves the dense mask transposed-shape: drop it
            # like resize_image does (the reference's flat w*h vec is
            # reinterpreted into garbage, never a crash; indexing the
            # stale dense shape here would raise IndexError)
            ctx.mask = None
        ctx.canvas_ops.append(CanvasOpRequest("rot90cw"))
        return UNIT

    @register("rotate_canvas_90ccw")
    def rotate_canvas_90ccw():
        ctx.pixels = tfm.rotate_90ccw(ctx.pixels)
        ctx.width, ctx.height = ctx.height, ctx.width
        if ctx.mask is not None:
            # a dim swap leaves the dense mask transposed-shape: drop it
            # like resize_image does (the reference's flat w*h vec is
            # reinterpreted into garbage, never a crash; indexing the
            # stale dense shape here would raise IndexError)
            ctx.mask = None
        ctx.canvas_ops.append(CanvasOpRequest("rot90ccw"))
        return UNIT

    @register("rotate_canvas_180")
    def rotate_canvas_180():
        ctx.pixels = tfm.rotate_180(ctx.pixels)
        ctx.canvas_ops.append(CanvasOpRequest("rot180"))
        return UNIT

    _FILTER_ALIASES = {
        "nearest": "nearest", "bilinear": "bilinear", "bicubic": "bicubic",
        "lanczos": "lanczos3", "lanczos3": "lanczos3",
    }

    @register("resize_image")
    def resize_image(new_w, new_h, method="bilinear"):
        nw = min(max(_as_int(new_w), 1), 32768)
        nh = min(max(_as_int(new_h), 1), 32768)
        filt = _FILTER_ALIASES.get(str(method).lower(), "bilinear")
        if nw == ctx.width and nh == ctx.height:
            return UNIT
        ctx.pixels = tfm.resize(ctx.pixels, nw, nh, filt)
        ctx.width, ctx.height = nw, nh
        if ctx.mask is not None:
            ctx.mask = None  # reference leaves the mask stale; drop for safety
        ctx.canvas_ops.append(CanvasOpRequest("resize_image", w=nw, h=nh, filter=filt))
        return UNIT

    _ANCHORS = {
        "top-left": (0, 0), "tl": (0, 0), "top-center": (1, 0), "tc": (1, 0),
        "top-right": (2, 0), "tr": (2, 0), "center-left": (0, 1), "cl": (0, 1),
        "center": (1, 1), "c": (1, 1), "center-right": (2, 1), "cr": (2, 1),
        "bottom-left": (0, 2), "bl": (0, 2), "bottom-center": (1, 2), "bc": (1, 2),
        "bottom-right": (2, 2), "br": (2, 2),
    }

    @register("resize_canvas")
    def resize_canvas(new_w, new_h, anchor="top-left"):
        nw = min(max(_as_int(new_w), 1), 32768)
        nh = min(max(_as_int(new_h), 1), 32768)
        at = _ANCHORS.get(str(anchor).lower(), (0, 0))
        ctx.pixels = tfm.resize_canvas(ctx.pixels, nw, nh, at, (0, 0, 0, 0))
        ctx.width, ctx.height = nw, nh
        if ctx.mask is not None:
            ctx.mask = None
        ctx.canvas_ops.append(CanvasOpRequest("resize_canvas", w=nw, h=nh, anchor=at))
        return UNIT

    # -- utility --------------------------------------------------------------

    @register("print")
    def print_(msg=""):
        ctx.console.append(to_display(msg) if not isinstance(msg, str) else msg)
        return UNIT

    @register("print_line")
    def print_line(msg=""):
        ctx.console.append(to_display(msg) if not isinstance(msg, str) else msg)
        return UNIT

    @register("debug")
    def debug(msg=""):
        ctx.console.append(to_display(msg))
        return UNIT

    @register("sleep")
    def sleep(ms):
        time.sleep(min(max(_as_int(ms), 0), 10_000) / 1000.0)
        return UNIT

    @register("progress")
    def progress(frac):
        ctx.progress = min(max(_as_float(frac), 0.0), 1.0)
        return UNIT

    @register("rand_int")
    def rand_int(lo, hi):
        lo, hi = _as_int(lo), _as_int(hi)
        if lo >= hi:
            return lo
        s = ctx.xorshift64()
        return lo + (s % max(hi - lo, 1))

    @register("rand_float")
    def rand_float(lo=None, hi=None):
        s = ctx.xorshift64()
        if lo is None:
            return s / float(U64_MASK)
        lo, hi = _as_float(lo), _as_float(hi)
        if lo >= hi:
            return lo
        return lo + (s / float(U64_MASK)) * (hi - lo)

    def _clamp(v, lo, hi):
        return max(lo, min(hi, v))

    register("clamp")(lambda v, lo, hi: _clamp(v, lo, hi))
    register("clamp_f")(lambda v, lo, hi: _clamp(v, lo, hi))
    register("lerp")(lambda a, b, t: a + (b - a) * t)
    register("distance")(
        lambda x1, y1, x2, y2: math.sqrt((x2 - x1) ** 2 + (y2 - y1) ** 2)
    )
    def _fmin(a, b):
        # Rust f64::min/max return the NON-NaN operand (Python's min/max
        # propagate NaN when it is the first argument)
        a, b = _as_float(a), _as_float(b)
        if a != a:
            return b
        if b != b:
            return a
        return min(a, b)

    def _fmax(a, b):
        a, b = _as_float(a), _as_float(b)
        if a != a:
            return b
        if b != b:
            return a
        return max(a, b)

    def _generic_min(a, b):
        if isinstance(a, float) or isinstance(b, float):
            return _fmin(a, b)
        return min(a, b)

    def _generic_max(a, b):
        if isinstance(a, float) or isinstance(b, float):
            return _fmax(a, b)
        return max(a, b)

    def _checked_abs(x):
        # checked i64: abs(i64::MIN) overflows (Rhai default build)
        if isinstance(x, int) and not isinstance(x, bool) \
                and x == -(1 << 63):
            raise RhaiRuntimeError(f"integer overflow: abs({x})")
        return abs(x)

    register("abs")(_checked_abs)
    register("min")(_generic_min)
    register("max")(_generic_max)
    register("abs_i")(lambda x: _checked_abs(_as_int(x)))
    register("min_i")(lambda a, b: min(_as_int(a), _as_int(b)))
    register("max_i")(lambda a, b: max(_as_int(a), _as_int(b)))
    register("min_f")(_fmin)
    register("max_f")(_fmax)
    register("floor")(lambda x: float(math.floor(_as_float(x))))
    register("ceil")(lambda x: float(math.ceil(_as_float(x))))

    @register("round")
    def _round(x):
        # f64::round (half away from zero); validates the arg like every
        # other float fn, and IEEE specials pass through.  Computed via the
        # EXACT fraction (x - floor(x) is exact in f64), not floor(x+0.5),
        # whose addition can round up across the boundary at
        # x = 0.5 - 2^-54.
        x = _as_float(x)
        if x != x or math.isinf(x):
            return x
        f = float(math.floor(abs(x)))
        r = f + 1.0 if abs(x) - f >= 0.5 else f
        return r if x >= 0 else -r

    @register("sqrt")
    def _sqrt(x):
        # f64::sqrt: negative -> NaN (math.sqrt raises an uncatchable
        # ValueError)
        x = _as_float(x)
        return math.sqrt(x) if x >= 0.0 or x != x else float("nan")

    @register("pow")
    def _pow(x, y):
        # f64::powf is full IEEE: (-2.0)**0.5 = NaN (Python makes it
        # complex), 0.0**-1.0 = inf (Python raises ZeroDivisionError)
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.power(np.float64(_as_float(x)),
                                  np.float64(_as_float(y))))
    register("sin")(lambda x: math.sin(_as_float(x)))
    register("cos")(lambda x: math.cos(_as_float(x)))
    register("tan")(lambda x: math.tan(_as_float(x)))
    register("atan2")(lambda y, x: math.atan2(_as_float(y), _as_float(x)))
    register("PI")(lambda: math.pi)

    @register("rgb_to_hsl")
    def rgb_to_hsl(r, g, b):
        rf = _clamp(_as_int(r), 0, 255) / 255.0
        gf = _clamp(_as_int(g), 0, 255) / 255.0
        bf = _clamp(_as_int(b), 0, 255) / 255.0
        mx = max(rf, gf, bf)
        mn = min(rf, gf, bf)
        l = (mx + mn) / 2.0
        if abs(mx - mn) < 1e-10:
            return [0.0, 0.0, l * 100.0]
        d = mx - mn
        s = d / (2.0 - mx - mn) if l > 0.5 else d / (mx + mn)
        if abs(mx - rf) < 1e-10:
            h = (gf - bf) / d + (6.0 if gf < bf else 0.0)
        elif abs(mx - gf) < 1e-10:
            h = (bf - rf) / d + 2.0
        else:
            h = (rf - gf) / d + 4.0
        return [h * 60.0, s * 100.0, l * 100.0]

    @register("hsl_to_rgb")
    def hsl_to_rgb(h, s, l):
        s = _as_float(s) / 100.0
        l = _as_float(l) / 100.0
        c = (1.0 - abs(2.0 * l - 1.0)) * s
        h2 = _as_float(h) / 60.0
        x = c * (1.0 - abs(math.fmod(h2, 2.0) - 1.0))
        sector = int(h2)
        r1, g1, b1 = {
            0: (c, x, 0.0), 1: (x, c, 0.0), 2: (0.0, c, x),
            3: (0.0, x, c), 4: (x, 0.0, c),
        }.get(sector, (c, 0.0, x))
        m = l - c / 2.0

        def rnd(v):
            return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))

        return [rnd((r1 + m) * 255.0), rnd((g1 + m) * 255.0), rnd((b1 + m) * 255.0)]

    # -- selection ------------------------------------------------------------

    @register("select_rect")
    def select_rect(x1, y1, x2, y2):
        w, h = ctx.width, ctx.height
        min_x = min(max(_as_int(x1), 0), w)
        min_y = min(max(_as_int(y1), 0), h)
        max_x = min(max(_as_int(x2), 0), w)
        max_y = min(max(_as_int(y2), 0), h)
        mask = np.zeros((h, w), np.uint8)
        mask[min_y:max_y, min_x:max_x] = 255
        ctx.mask = mask
        return UNIT

    @register("select_ellipse")
    def select_ellipse(cx, cy, rx, ry):
        w, h = ctx.width, ctx.height
        rx2 = max(_as_float(rx) ** 2, 0.001)
        ry2 = max(_as_float(ry) ** 2, 0.001)
        xs = np.arange(w, dtype=np.float64) - _as_float(cx)
        ys = np.arange(h, dtype=np.float64) - _as_float(cy)
        inside = (xs[None, :] ** 2) / rx2 + (ys[:, None] ** 2) / ry2 <= 1.0
        ctx.mask = np.where(inside, 255, 0).astype(np.uint8)
        return UNIT

    @register("clear_selection")
    def clear_selection():
        ctx.mask = None
        return UNIT

    @register("has_selection")
    def has_selection():
        return ctx.mask is not None

    @register("invert_selection")
    def invert_selection():
        if ctx.mask is not None:
            ctx.mask = 255 - ctx.mask
        else:
            # no selection means everything selected; inverting selects nothing
            ctx.mask = np.zeros((ctx.height, ctx.width), np.uint8)
        return UNIT

    @register("fill_selected")
    def fill_selected(r, g, b, a):
        color = [max(0, min(255, _as_int(v))) for v in (r, g, b, a)]
        if ctx.mask is None:
            ctx.pixels[...] = color
        else:
            ctx.pixels[ctx.mask > 0] = color
        return UNIT

    @register("delete_selected")
    def delete_selected():
        if ctx.mask is None:
            ctx.pixels[...] = 0
        else:
            ctx.pixels[ctx.mask > 0] = 0
        return UNIT

    return fns
