"""Batched CLI runner on one device (paintfe_tpu.parallel.batch
counterpart, `run_sharded_batch`).

Strategy: trace the script's op chain once (pipeline.trace_script); bucket
inputs by dimensions so each bucket is one [N, H, W, 4] batch; run each
bucket through the chain on the device once FLUSH_AT images have gathered
(and the remainder at the end); encode results behind the compute on a
pool.  Scripts that touch pixels directly run per image, still with
keep-going semantics.

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


def run_sharded_batch(inputs: List[pathlib.Path], args, fmt: str,
                      script_source: Optional[str]) -> int:
    import concurrent.futures

    from paintfe_tpu_torch.cli import build_output_path, load_image
    from paintfe_tpu_torch.parallel.pipeline import (NotVectorizable,
                                                     run_batch, trace_script)
    from paintfe_tpu_torch.parallel.prefetch import prefetch_images

    device = args.device
    ops = []
    per_bucket_trace = False
    if script_source:
        try:
            ops = trace_script(script_source)
        except NotVectorizable as e:
            if str(e) in ("width", "height"):
                # dimension-derived op params: re-trace per shape bucket so
                # width()/height() report the real dims
                per_bucket_trace = True
            else:
                if args.verbose:
                    print(f"note: script uses per-pixel API ({e}); "
                          "running per-image")
                return _fallback_serial(inputs, args, fmt, script_source)
        except Exception as e:
            print(f"  error: script error: {e}", file=sys.stderr)
            return 1

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

    def run_per_image(idxs, loaded):
        for i in idxs:
            loaded.pop(i, None)
            if _run_one_safe(inputs[i], args, fmt, script_source):
                state["done"] += 1
            else:
                state["failed"] = True

    def flush_bucket(shape, idxs, loaded):
        """Compute one static-shape batch.  A bucket failure keeps going:
        its images fall back to the per-image path, which reports each
        error itself."""
        try:
            bops = ops
            if per_bucket_trace:
                bops = trace_script(script_source, dims=(shape[1], shape[0]))
            batch = np.stack([loaded[i] for i in idxs])
            out = run_batch(batch, bops, device)
        except NotVectorizable:
            run_per_image(idxs, loaded)
            return
        except Exception as e:
            print(f"  error: batch of {len(idxs)} {shape[1]}x{shape[0]} "
                  f"images failed ({e}); retrying per-image", file=sys.stderr)
            run_per_image(idxs, loaded)
            return
        for k, i in enumerate(idxs):
            loaded.pop(i)
            save_one(i, out[k])

    # Layered containers need the full canvas path (script on the active
    # layer, canvas-op replay, flatten): the serial runner handles them
    # with identical semantics.
    flat_idxs = []
    for idx, p in enumerate(inputs):
        if pathlib.Path(p).suffix.lower() in (".pfe", ".pdn"):
            run_per_image([idx], {})
        else:
            flat_idxs.append(idx)

    # Stream decode -> bucket -> flush: the decode-ahead window stays
    # bounded.
    buckets = defaultdict(list)  # (h, w) -> [input index]
    loaded = {}
    try:
        for k, (path, img) in enumerate(
                prefetch_images([inputs[i] for i in flat_idxs], load=load_image)):
            idx = flat_idxs[k]
            if isinstance(img, Exception):
                print(f"  error: {img}", file=sys.stderr)
                state["failed"] = True
                continue
            loaded[idx] = img
            shape = img.shape[:2]
            buckets[shape].append(idx)
            if len(buckets[shape]) >= FLUSH_AT:
                flush_bucket(shape, buckets.pop(shape), loaded)
        for shape, idxs in buckets.items():
            flush_bucket(shape, idxs, loaded)
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
