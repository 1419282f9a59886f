"""Public script-execution API (paintfe_tpu.scripting.engine counterpart).

Behavioral contract: scripting.rs:1489-1821 — `compile_script`,
`execute_script_sync(source, pixels, w, h, mask) -> (pixels, w, h, console,
canvas_ops)`; ScriptError carries a message plus best-effort line/column.
`execute_script_sync` takes a torch `device` for the device-side ops.
`execute_script_async` runs a script on a worker thread and streams
`ScriptMessage`s (scripting.rs:222-252, 1512-1630); the worker may launch
on a CUDA stream of its own.  `apply_canvas_ops` replays canvas-wide
requests on the other layers (scripting.rs:1640-1723).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from paintfe_tpu_torch.ops import transform as tfm
from paintfe_tpu_torch.scripting.api import CanvasOpRequest, ScriptContext, build_host_fns
from paintfe_tpu_torch.scripting.interp import Interpreter, RhaiRuntimeError
from paintfe_tpu_torch.scripting.rhai_ast import RhaiSyntaxError, parse


@dataclasses.dataclass
class ScriptError(Exception):
    message: str
    line: Optional[int] = None
    column: Optional[int] = None

    def __str__(self):
        loc = f" (line {self.line}, position {self.column})" if self.line else ""
        return self.message + loc

    def friendly_message(self) -> str:
        """Categorized human-friendly explanation with tips — the same
        error-message contract as the reference (scripting.rs:96-200)."""
        raw = self.message
        low = raw.lower()
        parts = []
        if self.line is not None and self.column is not None:
            parts.append(f"Error on line {self.line}, column {self.column}:")
        elif self.line is not None:
            parts.append(f"Error on line {self.line}:")
        else:
            parts.append("Script error:")
        if "function not found" in low:
            # reference keeps the full "name (argtypes)" desc, trimming a
            # trailing " (line N, ..." location only (scripting.rs:115-135)
            fn_part = raw.split(":", 1)[1] if ":" in raw else ""
            desc = fn_part.split(" (line ")[0].strip()
            parts.append(f"  Could not find function: {desc or raw}")
            name = desc.split("(")[0].strip()
            if name and (len(name) <= 3
                         or all(c.islower() or c == "_" for c in name)):
                parts += [
                    "",
                    "  Tip: If this is a closure stored in a variable, use .call() syntax:",
                    f"    let {name} = |x| {{ x * 2 }};",
                    f"    {name}.call(42);   // ✓ correct",
                    f"    {name}(42);        // ✗ won't work",
                ]
        elif "variable" in low and "not found" in low:
            name = raw.split("'")[1] if "'" in raw else ""
            parts.append(f"  Variable '{name}' is not defined.")
            parts += ["", "  Tip: Make sure you declared it with 'let' before using it:",
                      f"    let {name} = 0;"]
        elif "unsupported rhai feature" in low or "reserved keyword" in low:
            parts.append(f"  {raw}")
        elif "operation limit" in low:
            parts += [
                "  Script exceeded the maximum operation limit (50 million ops).",
                "",
                "  Tip: Your script may have an infinite loop, or is processing",
                "  too many pixels. Try processing a smaller region with for_region(),",
                "  or use built-in apply_* functions which run natively.",
            ]
        elif "index error" in low or ("index" in low and "out of" in low):
            parts.append(f"  {raw}")
            parts += ["", "  Tip: An array index is out of bounds. Check array lengths",
                      "  with .len() before accessing elements."]
        elif "expected" in low or "unexpected" in low or "unterminated" in low:
            parts.append(f"  Syntax error: {raw}")
            parts += ["", "  Tip: Check for missing semicolons, brackets, or typos "
                          "near this line."]
        elif "cancelled" in low:
            parts.append("  Script was cancelled.")
        else:
            parts.append(f"  {raw}")
        return "\n".join(parts)


def compile_script(source: str):
    """Parse-check a script; raises ScriptError on syntax errors."""
    try:
        return parse(source)
    except RhaiSyntaxError as e:
        raise ScriptError(e.message, e.line, e.column)


def execute_script_sync(
    source: str,
    pixels: np.ndarray,
    width: int,
    height: int,
    mask: Optional[np.ndarray] = None,
    rng_seed: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, int, int, List[str], List[CanvasOpRequest]]:
    """Run a script synchronously on one layer buffer.

    `pixels` may be flat RGBA bytes or [H, W, 4]; returns the possibly
    resized buffer plus console output and queued canvas ops.  The
    device-side ops run on `device`: the card unless the caller passes
    "cpu"; CUDA with no card raises RuntimeError.
    """
    compile_script(source)  # surface syntax errors first, like engine.compile
    ctx = ScriptContext(np.asarray(pixels, np.uint8), width, height, mask,
                        rng_seed, device)
    interp_ref = {}
    fns = build_host_fns(ctx, interp_ref)
    interp = Interpreter(fns)
    interp_ref["interp"] = interp
    try:
        _run_script(interp, source)
    except RhaiSyntaxError as e:
        raise ScriptError(e.message, e.line, e.column)
    except RhaiRuntimeError as e:
        raise ScriptError(e.message)
    return ctx.pixels, ctx.width, ctx.height, ctx.console, ctx.canvas_ops


def _run_script(interp: Interpreter, source: str):
    """Run through the Python-bytecode fast path (pycompile) when the
    script is closure-free; the tree-walker otherwise (it is the semantic
    oracle and the bulk vectorizer's home — see pycompile.py)."""
    from paintfe_tpu_torch.scripting.pycompile import try_compile

    runner = try_compile(source)
    if runner is not None:
        runner(interp)
    else:
        interp.run(source)


_LAYER_OPS = {
    "flip_h": tfm.flip_horizontal, "flip_v": tfm.flip_vertical,
    "rot90cw": tfm.rotate_90cw, "rot90ccw": tfm.rotate_90ccw,
    "rot180": tfm.rotate_180,
}


def _layer_op(op: CanvasOpRequest):
    """The per-layer function of one canvas op."""
    if op.kind == "resize_image":
        return lambda px: tfm.resize(px, op.w, op.h, op.filter)
    if op.kind == "resize_canvas":
        return lambda px: tfm.resize_canvas(px, op.w, op.h, op.anchor)
    return _LAYER_OPS[op.kind]


def apply_canvas_ops(canvas, ops: List[CanvasOpRequest], skip_layer: int):
    """Replay canvas-wide ops on every layer except `skip_layer` (which
    already received them inside the script), then fix canvas dims
    (scripting.rs:1640-1723)."""
    for op in ops:
        fn = _layer_op(op)
        for idx, layer in enumerate(canvas.layers):
            if idx != skip_layer:
                layer.pixels = fn(layer.pixels)
        if op.kind in ("rot90cw", "rot90ccw"):
            canvas.width, canvas.height = canvas.height, canvas.width
        elif op.kind in ("resize_image", "resize_canvas"):
            canvas.width, canvas.height = op.w, op.h
        # The reference's apply_canvas_ops never touches the selection; the
        # dense [H, W] selection only goes when the dimensions changed and
        # its stale shape would crash downstream consumers.
        if canvas.selection is not None and canvas.selection.shape[:2] != (
                canvas.height, canvas.width):
            canvas.selection = None
        # Layer masks likewise: the reference's mask is a sparse TiledImage
        # whose out-of-bounds reads yield 0, so a dimension change leaves
        # stale masks readable (absent = 0).  Reproduce that with a
        # zero-pad/crop to the new dims.
        for layer in canvas.layers:
            m = layer.mask
            if m is not None and m.shape[:2] != (canvas.height, canvas.width):
                fixed = np.zeros((canvas.height, canvas.width), m.dtype)
                ch = min(m.shape[0], canvas.height)
                cw = min(m.shape[1], canvas.width)
                fixed[:ch, :cw] = m[:ch, :cw]
                layer.mask = fixed


# ---------------------------------------------------------------------------
# Async execution (GUI-mode parity: scripting.rs:222-252, 1512-1630)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScriptMessage:
    """Streamed from the worker thread: kind in {completed, error, preview,
    console, progress}."""

    kind: str
    payload: Any = None


def execute_script_async(source, pixels, width, height, mask=None, rng_seed=None,
                         cancel_event: Optional[threading.Event] = None,
                         device="cuda", stream=None):
    """Run a script on a worker thread; returns (thread, message_queue).

    Messages: console lines as they appear, progress updates, previews at
    each sleep, then exactly one terminal `completed` (payload = (pixels,
    w, h, console, canvas_ops, elapsed_ms)) or `error` (payload =
    ScriptError).  `cancel_event.set()` aborts between operations (the
    reference polls an AtomicBool from on_progress).  The device-side ops
    run on `device` (the card unless the caller passes "cpu"; CUDA with no
    card raises RuntimeError here, before the thread starts), and on a
    CUDA device under `stream` when one is given (a torch.cuda.Stream; the
    current stream is per thread, so the worker's is the device's default
    stream otherwise)."""
    from paintfe_tpu_torch.scripting.interp import RhaiSystemError
    from paintfe_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    messages: "queue.Queue[ScriptMessage]" = queue.Queue()
    cancel_event = cancel_event or threading.Event()

    def run():
        start = time.perf_counter()
        compile_script(source)
        ctx = ScriptContext(np.asarray(pixels, np.uint8), width, height, mask,
                            rng_seed, dev)
        interp_ref = {}
        fns = build_host_fns(ctx, interp_ref)

        orig_print = fns["print_line"]

        def streaming_print(msg=""):
            r = orig_print(msg)
            messages.put(ScriptMessage("console", ctx.console[-1]))
            return r

        fns["print_line"] = streaming_print
        fns["print"] = streaming_print

        orig_progress = fns["progress"]

        def streaming_progress(frac):
            r = orig_progress(frac)
            messages.put(ScriptMessage("progress", ctx.progress))
            return r

        fns["progress"] = streaming_progress

        orig_sleep = fns["sleep"]

        def preview_sleep(ms):
            messages.put(ScriptMessage("preview", (ctx.pixels.copy(), ctx.width,
                                                   ctx.height)))
            return orig_sleep(ms)

        fns["sleep"] = preview_sleep

        interp = Interpreter(fns)
        interp_ref["interp"] = interp
        orig_tick = interp.tick

        def cancellable_tick():
            if cancel_event.is_set() and interp.ops % 1024 == 0:
                # a system error: a script-level try/catch cannot swallow it
                raise RhaiSystemError("Script cancelled by user")
            orig_tick()

        interp.tick = cancellable_tick
        _run_script(interp, source)
        elapsed_ms = int((time.perf_counter() - start) * 1000)
        # Completed carries elapsed_ms like the reference's
        # ScriptMessage::Completed (scripting.rs:232, :1596-1608)
        return ScriptMessage("completed", (ctx.pixels, ctx.width, ctx.height,
                                           ctx.console, ctx.canvas_ops, elapsed_ms))

    def worker():
        import torch

        try:
            with (torch.cuda.stream(stream) if stream is not None and dev.type == "cuda"
                  else contextlib.nullcontext()):
                messages.put(run())
        except ScriptError as e:
            messages.put(ScriptMessage("error", e))
        except (RhaiSyntaxError, RhaiRuntimeError) as e:
            messages.put(ScriptMessage("error", ScriptError(str(e))))
        except BaseException as e:  # noqa: BLE001 - terminal-message contract
            # any other escape must still produce the terminal message: a
            # consumer draining the queue until one would hang otherwise
            messages.put(ScriptMessage(
                "error", ScriptError(f"internal script engine error: "
                                     f"{type(e).__name__}: {e}")))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    return thread, messages
