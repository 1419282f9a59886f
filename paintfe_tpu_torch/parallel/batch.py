"""Sharded CLI batch runner (paintfe_tpu.parallel.batch counterpart:
`run_sharded_batch`, and `run_sharded_frames` for --shard --animate).

Strategy: trace the script's op chain once (pipeline.trace_script); bucket
inputs by dimensions so each bucket is one [N, H, W, 4] batch; run each
bucket through the chain split over the device mesh (every card of this
process for --device cuda, the CPU for --device cpu) once FLUSH_AT images
have gathered (and the remainder at the end); encode results behind the
compute on a pool, or collect them as frames.  Scripts that touch pixels
directly run per image, still with keep-going semantics.  Raster inputs load through
the u8 codec, as the JAX package's --shard loads them (a 16-bit input is
PIL's 8-bit reading of it; a RAW camera file is developed on the run's
device, in the decode-ahead threads); layered documents (.pfe, .pdn) take
the serial canvas path.

This module imports only numpy and the codecs at the top: the encode pool's
spawn workers import it to find `_encode_one`.
"""

from __future__ import annotations

import pathlib
import sys
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np

FLUSH_AT = 64  # compute a shape bucket once this many images accumulate
PROC_THRESHOLD = 512 * 1024  # pixels; frames this large encode in processes
ENCODE_WINDOW = 16  # in-flight encodes, each holding a full output frame


def _encode_one(img, output_path, fmt, quality, webp_lossless,
                tiff_compression):
    """Encode worker (module-level: must pickle for the process pool)."""
    from paintfe_tpu_torch.io import codecs

    try:
        codecs.save_image(img, output_path, fmt, quality=quality,
                          webp_lossless=webp_lossless,
                          tiff_compression=tiff_compression)
        return True, f"  -> {output_path}"
    except codecs.CodecError as e:
        return False, f"  error: {e}"


_PROC_POOL = None


def _proc_pool():
    """Singleton spawn-context encode pool: PNG encode holds the GIL, so
    large frames need processes; worker start-up amortizes across runs."""
    global _PROC_POOL
    if _PROC_POOL is None:
        import concurrent.futures
        import multiprocessing

        _PROC_POOL = concurrent.futures.ProcessPoolExecutor(
            max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    return _PROC_POOL


def shutdown_encode_pool():
    """Stop the encode worker processes (they otherwise live until exit)."""
    global _PROC_POOL
    if _PROC_POOL is not None:
        _PROC_POOL.shutdown(wait=True)
        _PROC_POOL = None


# layered containers take the serial canvas path (script on the active
# layer, canvas-op replay, flatten), which a flat batch cannot model
LAYERED = (".pfe", ".pdn")


def _trace(script_source: Optional[str], verbose: bool):
    """The script's op chain for the batches, as (ops, retrace per bucket),
    or None when the script touches pixels and runs per image.  A script
    error raises."""
    from paintfe_tpu_torch.parallel.pipeline import NotVectorizable, trace_script

    if not script_source:
        return [], False
    try:
        return trace_script(script_source), False
    except NotVectorizable as e:
        if str(e) in ("width", "height"):
            # dimension-derived op params: re-trace per shape bucket so
            # width()/height() report the real dims
            return [], True
        if verbose:
            print(f"note: script uses per-pixel API ({e}); running per-image")
        return None


def _run_buckets(inputs, script_source, plan, device, per_image, on_result, state):
    """Layered inputs go to per_image(idx) one by one; the others decode
    ahead (a bounded window), gather in shape buckets, and each bucket runs
    as one batch over `device`'s mesh (run_batch: one launch a kernel per
    mesh entry) once FLUSH_AT images have gathered, the rest at the end.
    on_result(idx, image) takes each processed image; a bucket that fails
    retries its images with per_image, which reports each error itself; an
    input that does not decode sets state["failed"]."""
    from paintfe_tpu_torch.io import codecs
    from paintfe_tpu_torch.parallel.pipeline import NotVectorizable, run_batch, trace_script
    from paintfe_tpu_torch.parallel.prefetch import prefetch_images

    ops, per_bucket_trace = plan

    def flush(shape, idxs, loaded):
        try:
            bops = (trace_script(script_source, dims=(shape[1], shape[0]))
                    if per_bucket_trace else ops)
            out = run_batch(np.stack([loaded[i] for i in idxs]), bops, device)
        except NotVectorizable:
            out = None
        except Exception as e:
            print(f"  error: batch of {len(idxs)} {shape[1]}x{shape[0]} "
                  f"images failed ({e}); retrying per-image", file=sys.stderr)
            out = None
        for k, i in enumerate(idxs):
            loaded.pop(i)
            if out is None:
                per_image(i)
            else:
                on_result(i, out[k])

    flat = []
    for idx, p in enumerate(inputs):
        if pathlib.Path(p).suffix.lower() in LAYERED:
            per_image(idx)
        else:
            flat.append(idx)
    buckets = defaultdict(list)  # (h, w) -> [input index]
    loaded = {}
    def load(path):
        return codecs.load_image(path, device=device)

    for k, (_, img) in enumerate(prefetch_images([inputs[i] for i in flat], load)):
        idx = flat[k]
        if isinstance(img, Exception):
            print(f"  error: {img}", file=sys.stderr)
            state["failed"] = True
            continue
        loaded[idx] = img
        shape = img.shape[:2]
        buckets[shape].append(idx)
        if len(buckets[shape]) >= FLUSH_AT:
            flush(shape, buckets.pop(shape), loaded)
    for shape, idxs in buckets.items():
        flush(shape, idxs, loaded)


def run_sharded_batch(inputs: List[pathlib.Path], args, fmt: str,
                      script_source: Optional[str]) -> int:
    import concurrent.futures

    from paintfe_tpu_torch.cli import build_output_path

    try:
        plan = _trace(script_source, args.verbose)
    except Exception as e:
        print(f"  error: script error: {e}", file=sys.stderr)
        return 1
    if plan is None:
        return _fallback_serial(inputs, args, fmt, script_source)

    state = {"failed": False, "done": 0}
    t0 = time.time()

    thread_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    proc_pool = None
    encodes = []

    def _encode_args(idx):
        output_path = build_output_path(inputs[idx], args.output,
                                        args.output_dir, fmt)
        return (str(output_path), fmt, args.quality, not args.webp_lossy,
                args.tiff_compression)

    def _settle(fut):
        try:
            ok, msg = fut.result()
        except Exception as e:  # worker crash (BrokenProcessPool...)
            ok, msg = False, f"  error: encode worker failed: {e}"
        if ok:
            state["done"] += 1
            if args.verbose:
                print(msg)
        else:
            print(msg, file=sys.stderr)
            state["failed"] = True

    def save_one(idx, img):
        nonlocal proc_pool
        while len(encodes) >= ENCODE_WINDOW:
            _settle(encodes.pop(0))
        eargs = _encode_args(idx)
        if img.shape[0] * img.shape[1] >= PROC_THRESHOLD:
            if proc_pool is None:
                try:
                    proc_pool = _proc_pool()
                except (OSError, ValueError):
                    proc_pool = thread_pool  # restricted platforms
            encodes.append(proc_pool.submit(_encode_one, img, *eargs))
            return
        encodes.append(thread_pool.submit(_encode_one, img, *eargs))

    def per_image(idx):
        if _run_one_safe(inputs[idx], args, fmt, script_source):
            state["done"] += 1
        else:
            state["failed"] = True

    try:
        _run_buckets(inputs, script_source, plan, args.device, per_image, save_one, state)
    finally:
        for fut in encodes:
            _settle(fut)
        encodes.clear()
        thread_pool.shutdown(wait=True)

    if args.verbose:
        dt = time.time() - t0
        n = state["done"]
        print(f"batch: {n} images in {dt:.2f}s ({n / max(dt, 1e-9):.1f} img/s)")
    return 1 if state["failed"] else 0


def run_sharded_frames(inputs: List[pathlib.Path], args, script_source: Optional[str]):
    """The frames of `--shard --animate`: run_sharded_batch's bucketed
    batches, collecting processed frames instead of encoding files.
    Returns (frames in input order, failed); a failed input is skipped with
    keep-going semantics, as in the serial --animate loop, and a failed
    bucket retries its images one by one."""
    from paintfe_tpu_torch.cli import _INPUT_ERRORS, _compute_frame

    try:
        plan = _trace(script_source, args.verbose)
    except Exception as e:
        print(f"  error: script error: {e}", file=sys.stderr)
        return [], True
    frames = {}
    state = {"failed": False}

    def per_image(idx):
        try:
            frames[idx] = _compute_frame(inputs[idx], script_source, args.device)
        except _INPUT_ERRORS as e:
            print(f"  error: {e}", file=sys.stderr)
            state["failed"] = True

    def on_result(idx, img):
        frames[idx] = np.asarray(img)

    if plan is None:
        for idx in range(len(inputs)):
            per_image(idx)
    else:
        _run_buckets(inputs, script_source, plan, args.device, per_image, on_result, state)
    return [frames[i] for i in sorted(frames)], state["failed"]


def _run_one_safe(input_path, args, fmt, script_source) -> bool:
    from paintfe_tpu_torch.cli import build_output_path, run_one

    output_path = build_output_path(input_path, args.output, args.output_dir,
                                    fmt)
    try:
        run_one(
            input_path, output_path, script_source, fmt, args.quality,
            not args.webp_lossy, args.tiff_compression, args.flatten,
            args.verbose, device=args.device,
        )
        return True
    except Exception as e:  # keep-going boundary: report, go on
        print(f"  error: {e}", file=sys.stderr)
        return False


def _fallback_serial(inputs, args, fmt, script_source) -> int:
    any_failure = False
    for input_path in inputs:
        if not _run_one_safe(input_path, args, fmt, script_source):
            any_failure = True
    return 1 if any_failure else 0
