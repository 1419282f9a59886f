"""Headless CLI batch mode of the port (paintfe_tpu.cli counterpart).

Behavioral contract: src/cli.rs — the same flags, glob resolve/dedup,
per-file load -> script on the active layer -> canvas-op replay on the
other layers -> flatten -> encode, format inference, collision-safe `_out`
suffix, and exit code 0 when every input is OK, 1 otherwise, with
keep-going semantics.  `--device {cuda,cpu}` picks the torch device the
device-side ops and the flatten run on; `cuda` with no card is an error,
never a silent run on the CPU.  `--shard` runs the traced op chain over
shape-bucketed batches on that device (parallel/batch.py); layered
documents (.pfe, .pdn) take the serial canvas path there too.  Inputs are
raster images, 16-bit PNGs and 16/32-bit TIFFs (their deep payload kept
and exported), .pfe documents (text layers rasterized before the flatten),
Paint.NET .pdn documents and RAW camera files (DNG, CR2, NEF/NRW, ARW,
PEF, SRW, ORF, RW2/RWL), developed on `--device` on every route.
`--animate OUT` writes every processed input as one frame of a GIF, APNG
or WebP animation (with --shard too); `--trace-dir DIR` writes a
torch.profiler trace of the serial run.  A multi-process launch
(PAINTFE_COORDINATOR, PAINTFE_NUM_PROCESSES, PAINTFE_PROCESS_ID; one
process per host, parallel/distributed.py) runs the --shard path on each
process's round-robin share of the inputs, and every process exits with
the code the processes agree on.

    python -m paintfe_tpu_torch.cli -i 'docs/*.pfe' -s fx.rhai \\
        --output-dir out -f png --device cuda
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import pathlib
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from paintfe_tpu_torch.core.canvas import Canvas, canonicalize_tiles
from paintfe_tpu_torch.io import codecs, deep_export, pfe
from paintfe_tpu_torch.io.nrbf import NrbfError
from paintfe_tpu_torch.io.pdn import PdnError
from paintfe_tpu_torch.io.raw import RawError
from paintfe_tpu_torch.scripting import ScriptError, apply_canvas_ops, execute_script_sync

# per-file keep-going: every error class an input file can produce (a class
# missing here crashes the whole batch)
_INPUT_ERRORS = (codecs.CodecError, pfe.PfeError, PdnError, NrbfError, RawError,
                 ScriptError, OSError, ValueError)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paintfe-tpu-torch",
        description="PaintFE-compatible headless batch processor (PyTorch + CUDA)",
    )
    p.add_argument("-i", "--input", nargs="+", action="extend", required=True,
                   help="input file(s); glob patterns accepted; the flag "
                        "may be repeated (cli.rs:43-48 semantics)")
    p.add_argument("-s", "--script", metavar="SCRIPT.rhai",
                   help="script to execute on each input image")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="output path (single-file input only)")
    p.add_argument("--output-dir", metavar="DIR",
                   help="output directory for batch processing")
    p.add_argument("-f", "--format",
                   help="png, jpeg, webp, bmp, tga, ico, tiff, gif, pfe")
    p.add_argument("-q", "--quality", type=int, default=90, metavar="1-100")
    p.add_argument("--webp-lossy", action="store_true",
                   help="write WebP lossily using --quality")
    p.add_argument("--tiff-compression", default="none",
                   choices=["none", "lzw", "deflate"])
    p.add_argument("--flatten", action=argparse.BooleanOptionalAction, default=True,
                   help="flatten visible layers before saving")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings (load/script/flatten/encode)")
    p.add_argument("--trace-dir", metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR")
    p.add_argument("--shard", action="store_true",
                   help="run the batch as shape-bucketed batches on the device")
    p.add_argument("--animate", metavar="OUT",
                   help="combine all processed inputs into one animated "
                        "GIF/APNG/WebP at OUT (each input = one frame)")
    p.add_argument("--fps", type=float, default=10.0,
                   help="frame rate for --animate (default 10)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device for the device-side ops (default cuda)")
    return p


def resolve_inputs(patterns: List[str]) -> List[pathlib.Path]:
    """Literal paths first, else glob expansion; ordered, deduplicated."""
    result: List[pathlib.Path] = []
    for pattern in patterns:
        as_path = pathlib.Path(pattern)
        if as_path.exists():
            if as_path not in result:
                result.append(as_path)
            continue
        matches = sorted(globlib.glob(pattern))
        if not matches:
            print(f"warning: pattern '{pattern}' matched no files.", file=sys.stderr)
        for m in matches:
            mp = pathlib.Path(m)
            if mp not in result:
                result.append(mp)
    return result


_EXT_FORMATS = {
    "jpg": "jpeg", "jpeg": "jpeg", "webp": "webp", "bmp": "bmp", "tga": "tga",
    "ico": "ico", "tiff": "tiff", "tif": "tiff", "gif": "gif", "pfe": "pfe",
}


def parse_format(format_arg: Optional[str], output: Optional[str]) -> str:
    if format_arg:
        return _EXT_FORMATS.get(format_arg.lower(), "png")
    if output:
        ext = pathlib.Path(output).suffix.lower().lstrip(".")
        return _EXT_FORMATS.get(ext, "png")
    return "png"


def build_output_path(input_path: pathlib.Path, output: Optional[str],
                      output_dir: Optional[str], fmt: str) -> pathlib.Path:
    if output:
        return pathlib.Path(output)
    ext = codecs.format_extension(fmt)
    stem = input_path.stem
    if output_dir:
        return pathlib.Path(output_dir) / f"{stem}.{ext}"
    parent = input_path.parent
    candidate = parent / f"{stem}.{ext}"
    if candidate == input_path:
        return parent / f"{stem}_out.{ext}"
    return candidate


def load_canvas(path: pathlib.Path, device="cuda") -> Canvas:
    """One input as a document: a .pfe or .pdn as its layers, a 16-bit PNG
    or 16/32-bit TIFF as one layer that keeps its deep payload, any other
    raster image as a one-layer canvas (a RAW camera file developed on
    `device`)."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".pfe":
        return pfe.load_pfe(str(path))
    if path.suffix.lower() == ".pdn":
        from paintfe_tpu_torch.io import pdn

        return pdn.load_pdn(str(path))
    deep = deep_export.load_deep_image(path)
    if deep is not None:
        preview, pixel_format, buf = deep
        canvas = Canvas.from_image(preview)
        canvas.layers[0].pixel_format = pixel_format
        canvas.layers[0].deep_pixels = buf
        return canvas
    return Canvas.from_image(codecs.load_image(path, device=device))


def _commit_script_result(canvas, idx, result, new_w, new_h, canvas_ops):
    """Commit a script's u8 result to the active layer: canonicalize
    transparent tiles (the layer-commit invariant), replay canvas-wide ops
    on the other layers, fix dims, and keep the deep payload consistent (a
    changed u8 result or new dims rebuild it from the result, since the
    script semantics are u8)."""
    from paintfe_tpu_torch.core.deep import DeepRgbaBuffer, PixelFormat

    layer = canvas.layers[idx]
    old_pixels = layer.pixels
    new_pixels = canonicalize_tiles(np.asarray(result, np.uint8).reshape(new_h, new_w, 4))
    if layer.deep_pixels is not None and (
            new_pixels.shape != old_pixels.shape
            or not np.array_equal(new_pixels, old_pixels)):
        fmt = (PixelFormat(layer.pixel_format) if layer.pixel_format
               is not None else PixelFormat.RGBA_U8)
        layer.deep_pixels = DeepRgbaBuffer.from_rgba8(new_pixels, fmt)
    layer.pixels = new_pixels
    if canvas_ops:
        apply_canvas_ops(canvas, canvas_ops, skip_layer=idx)
    canvas.width, canvas.height = new_w, new_h


def run_one(input_path: pathlib.Path, output_path: pathlib.Path,
            script_source: Optional[str], fmt: str, quality: int,
            webp_lossless: bool, tiff_compression: str, flatten: bool,
            verbose: bool, timer=None, device="cuda"):
    """Load, script, flatten and encode one input on `device` (the card
    unless the caller passes "cpu"; CUDA with no card raises RuntimeError)."""
    from paintfe_tpu_torch.utils.device import resolve_device
    from paintfe_tpu_torch.utils.profiling import StageTimer

    device = resolve_device(device)
    if timer is None:
        timer = StageTimer(device)
    with timer.stage("load"):
        canvas = load_canvas(input_path, device)

    if script_source is not None:
        idx = canvas.active_layer_index
        with timer.stage("script"):
            result, new_w, new_h, console, canvas_ops = execute_script_sync(
                script_source, canvas.layers[idx].pixels, canvas.width,
                canvas.height, canvas.selection, device=device)
        if verbose:
            for line in console:
                print(f"  [script] {line}")
        _commit_script_result(canvas, idx, result, new_w, new_h, canvas_ops)

    if fmt == "pfe":
        # untimed, as the JAX CLI leaves it: --profile prints no stage for it
        pfe.save_pfe(canvas, str(output_path))
        return

    # dirty text layers rasterize before any flatten or encode (cli.rs:275
    # state.ensure_all_text_layers_rasterized); untimed, as in the JAX CLI
    from paintfe_tpu_torch.ops.text_layer import ensure_text_layers_rasterized

    ensure_text_layers_rasterized(canvas, device)

    if flatten and (len(canvas.layers) > 1 or deep_export.needs_deep_export(canvas)):
        # depth-aware export (io.rs:1413-1453, :1588-1631); plain
        # single-layer documents skip the compositor (cli.rs:282-293)
        with timer.stage("flatten"):
            prep = deep_export.prepare_export_image(canvas, device=device)
        with timer.stage("encode"):
            deep_export.encode_prepared_and_write(
                prep, output_path, fmt, quality=quality,
                tiff_compression=tiff_compression, webp_lossless=webp_lossless)
        return
    with timer.stage("encode"):
        codecs.save_image(canvas.active_layer.pixels, output_path, fmt,
                          quality=quality, webp_lossless=webp_lossless,
                          tiff_compression=tiff_compression)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1

    inputs = resolve_inputs(args.input)
    if not inputs:
        print("error: no input files matched the given pattern(s).", file=sys.stderr)
        return 1
    if len(inputs) > 1 and args.output and not args.output_dir:
        print(
            f"error: {len(inputs)} input files given but --output only accepts a "
            "single file path.\nUse --output-dir for batch processing.",
            file=sys.stderr,
        )
        return 1

    fmt = parse_format(args.format, args.output)

    script_source = None
    if args.script:
        try:
            script_source = pathlib.Path(args.script).read_text()
        except OSError as e:
            print(f"error: could not read script '{args.script}': {e}", file=sys.stderr)
            return 1

    if args.output_dir:
        pathlib.Path(args.output_dir).mkdir(parents=True, exist_ok=True)

    if args.animate:
        return _run_animate(inputs, args, script_source)
    # The sharded path runs whenever --shard was asked for, or the process
    # was launched as part of an explicitly wired multi-process job:
    # without this, every process would run the same files, write the same
    # outputs at once, and never agree on an exit code.
    if args.shard or os.environ.get("PAINTFE_COORDINATOR"):
        from paintfe_tpu_torch.parallel import distributed
        from paintfe_tpu_torch.parallel.batch import run_sharded_batch

        try:
            multi_process = distributed.maybe_initialize(verbose=args.verbose)
        except (RuntimeError, ValueError) as e:  # partial wiring, bad address
            print(f"error: {e}", file=sys.stderr)
            return 1
        if multi_process:
            # each process takes its round-robin share of the inputs and
            # runs it on its own cards; the exit code is agreed by all
            inputs = distributed.shard_inputs(inputs)
            if args.verbose:
                print(f"[distributed] process {distributed.rank()} handles "
                      f"{len(inputs)} input(s)")
            rc = run_sharded_batch(inputs, args, fmt, script_source) if inputs else 0
            if args.verbose:
                from paintfe_tpu_torch.utils.cuda_build import launch_counts

                print(f"[distributed] process {distributed.rank()} kernel launches: "
                      f"{json.dumps(launch_counts())}")
            return 0 if distributed.all_processes_ok(rc == 0) else 1
        return run_sharded_batch(inputs, args, fmt, script_source)

    from paintfe_tpu_torch.utils.profiling import StageTimer, trace

    total = len(inputs)
    multi = total > 1
    any_failure = False
    # `with`: an exception escaping the loop still finalizes the trace
    with trace(args.trace_dir):
        for i, input_path in enumerate(inputs):
            if multi or args.verbose:
                print(f"[{i + 1}/{total}] {input_path}")
            t0 = time.time()
            output_path = build_output_path(input_path, args.output,
                                            args.output_dir, fmt)
            timer = StageTimer(args.device) if args.profile else None
            try:
                run_one(
                    input_path, output_path, script_source, fmt, args.quality,
                    not args.webp_lossy, args.tiff_compression, args.flatten,
                    args.verbose, timer=timer, device=args.device,
                )
                if args.verbose or multi:
                    print(f"  -> {output_path} ({(time.time() - t0) * 1000:.0f}ms)")
                if timer is not None:
                    print(timer.report())
            except _INPUT_ERRORS as e:
                msg = e
                if isinstance(e, ScriptError):
                    msg = f"script error: {e}"
                print(f"  error: {msg}", file=sys.stderr)
                any_failure = True
    return 1 if any_failure else 0


def _compute_frame(input_path, script_source, device="cuda") -> np.ndarray:
    """One input as its processed, flattened frame (the --animate unit of
    work; may raise any of _INPUT_ERRORS)."""
    canvas = load_canvas(input_path, device)
    if script_source is not None:
        idx = canvas.active_layer_index
        result, new_w, new_h, _console, canvas_ops = execute_script_sync(
            script_source, canvas.layers[idx].pixels, canvas.width, canvas.height,
            canvas.selection, device=device)
        # the commit path of run_one (canonicalized tiles, deep sync)
        _commit_script_result(canvas, idx, result, new_w, new_h, canvas_ops)
    from paintfe_tpu_torch.ops.text_layer import ensure_text_layers_rasterized

    ensure_text_layers_rasterized(canvas, device)
    return (canvas.composite(device=device) if len(canvas.layers) > 1
            else canvas.active_layer.pixels)


_ANIMATION_FORMATS = {"gif": "gif", "png": "apng", "apng": "apng", "webp": "webp"}


def _run_animate(inputs, args, script_source) -> int:
    """Process every input, then encode all frames as one animation (each
    input one frame).  With --shard the frames come from the bucketed
    batches (parallel/batch.run_sharded_frames), byte-equal to this serial
    path and in input order.  A failed input drops its frame and makes the
    exit code 1."""
    ext = pathlib.Path(args.animate).suffix.lower().lstrip(".")
    anim_fmt = _ANIMATION_FORMATS.get(ext)
    if anim_fmt is None:
        print(f"error: --animate needs a .gif/.png/.webp path, got '{ext}'",
              file=sys.stderr)
        return 1
    if args.shard:
        from paintfe_tpu_torch.parallel.batch import run_sharded_frames

        frames, any_failure = run_sharded_frames(inputs, args, script_source)
    else:
        frames = []
        any_failure = False
        for input_path in inputs:
            try:
                frames.append(_compute_frame(input_path, script_source, args.device))
            except _INPUT_ERRORS as e:
                print(f"  error: {e}", file=sys.stderr)
                any_failure = True
    if not frames:
        return 1
    try:
        codecs.save_animation(frames, args.animate, anim_fmt, fps=args.fps,
                              quality=args.quality, webp_lossless=not args.webp_lossy)
        if args.verbose:
            print(f"  -> {args.animate} ({len(frames)} frames @ {args.fps} fps)")
    except codecs.CodecError as e:
        print(f"  error: {e}", file=sys.stderr)
        return 1
    return 1 if any_failure else 0


if __name__ == "__main__":
    sys.exit(main())
