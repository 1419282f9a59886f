#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (paintfe_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc.
It builds the port's CUDA kernels from csrc/, then:

  1. holds each kernel against its plain version on the card, byte for
     byte (tolerance 0), over several radii, fields, modes and shapes:
     K-blur (csrc/gaussian_blur.cu) against gaussian_blur_plain (with the
     radii at each limit of its tile geometry), K-chain (csrc/fused_chain.cu)
     against the plain fused_chain (both tile widths and every route limit,
     at opacities on both sides of its shared reciprocal, which is counted
     against __fdiv_rn over every u8 input), K-median (csrc/median.cu)
     against median_plain (every network radius, the first counting one,
     images smaller than the window), K-warp (csrc/warp_bilinear.cu) in
     both modes against gather_bilinear_plain (row widths and field
     offsets that take its vector path, its scalar path and its tail, and
     batches), K-composite
     (csrc/composite.cu) against composite_stack_plain over all 25 blend
     modes, opacities, conceal masks and initial accumulators, on pointers
     that take its vector path, its scalar path and its scalar tail, with
     its shared reciprocal counted against __fdiv_rn over every u8 input,
     and K-pass (csrc/blur_pass.cu) against gaussian_blur_pass_plain, at
     widths around each limit of its groups and segments and below its
     radius, on both of its routes;
  2. holds each of the 13 effect ops of the script API (EFFECT_OPS),
     resize (four filters) and resize_canvas, and each op of the menu path
     under an elliptic selection (menu_op_table: the 27 adjustment
     functions, the menu effects, the Liquify and mesh warps, the
     gradients), at 1920x1080 on the card against the same op on the CPU,
     byte for byte; then runs two
     execute_script_async workers at once, each on its own CUDA stream,
     blurring at different sigmas around a twist, 20 rounds at 1920x1080,
     each result held against the plain versions (K-blur's constant taps
     are shared by the streams);
  3. drives eleven main paths and one entry call, each with every kernel
     launch count set to 0 just before it and read just after:
     - the headline path: the serial CLI (one 3840x2160 PNG, --device
       cuda) and the --shard CLI (two 3840x2160 and two 1920x1080 PNGs,
       two shape buckets) on the headline script, then the headline 4K
       chain frame;
     - the spatial-effects path: the same two CLI runs on a script that
       blurs, takes the median, bulges and applies levels;
     - the layered-document path: six-layer V3 .pfe documents written with
       the port's save_pfe (an opaque-left background, MULTIPLY at 0.7,
       SOFT_LIGHT, a brightness/contrast adjustment layer at 0.6, SCREEN,
       a layer in a hidden folder; empty 64 px tiles in every layer) through
       the serial CLI (two 3840x2160 documents), --shard (those two and one
       1920x1080 document) and -f pfe, on a script that blurs the active
       layer and replays two canvas ops on the others; the active-tile mask
       built on the card must equal the host definition, and a preview
       overlay composited on the card the CPU flatten;
     - the effects path: the serial CLI (two 3840x2160 PNGs) and --shard
       (two 3840x2160 and two 1920x1080) on a script calling each of the
       13 effect ops once (K-blur twice, under sharpen and glow, and K-warp
       once, under twist, per image and per bucket), printing the --shard
       run's peak device memory; then one 3840x2160 six-layer document
       through resize_image and resize_canvas (replayed on the other
       layers) and the flatten on K-composite;
     - the inputs path (written from a seed): two 16-bit 3840x2160 PNGs
       whose rows cycle PNG filters 0-4, two 16-bit 3840x2160 TIFFs (deflate,
       LZW), a six-layer 3840x2160 .pdn and a 3840x2160
       .pfe with a text layer (outline, shadow of blur radius 6) through
       the headline script, serially (-f png, and -f tiff on the PNGs) and
       under --shard, each file equal to the same run's with --device cpu;
       --animate to APNG over two 4K PNGs and the .pdn and to GIF at
       1920x1080, serially and under --shard (equal files); and --trace-dir,
       whose trace must name K-blur's and K-composite's kernels; then each
       stage of the path timed alone (16-bit PNG load: zlib, defilter;
       .pdn load: NRBF, gzip; flatten; text rasterise; encodes);
     - the document-editing path: a six-layer 3840x2160 .pfe through
       Project.open, 24 edits (selections: ellipse, rect, feather, expand,
       contract, colour range, the magic wand on the card; bucket fill;
       a layer mask from the selection, inverted; duplicate and merge down
       as mask; copy, cut, paste as layer; colour-to-alpha; flood select;
       a selected-region flip; rotate 90, then 17.5 degrees bilinear on
       K-warp, every layer and mask in one batch, and -30 nearest; merge
       down on K-composite; crop), each pushed to the project's history,
       every layer and mask after each held against a second copy edited
       through the plain versions on the card; undo to the start (equal to
       the opened document) and redo to the end; composite_viewport,
       composite_lod, the soft proof, flatten, Project.save to .pfe and
       .png (bytes equal to the plain route's) and a reopen; exactly one
       K-warp launch and one K-composite launch for merge down and one a
       raster run for each flatten, no other kernel; each stage's wall
       time;
     - the menu-edit path: a six-layer 3840x2160 .pfe through
       Project.open and an elliptic selection, then each step of
       menu_steps on the active layer under the selection, each pushed to
       the history (the 27 adjustment functions, ops/luts feeding curves,
       levels and the gradient map, and a histogram read; bokeh, zoom,
       dents on K-warp, grid, canvas border, drop shadow on K-blur, pixel
       drag, RGB displace, contours, the colour filter; four Liquify
       strokes and the field's warp and a mesh warp of a displaced 4x3
       grid, both on K-warp; a linear and a radial eraser gradient on a
       new layer), every layer after each step held against a second copy
       edited through the plain versions on the card; undo to the start,
       redo to the end, flatten on K-composite and Project.save to .pfe
       and .png; exactly MENU_WARPS K-warp launches, MENU_BLURS K-blur
       launches and one K-composite launch a raster run of the flatten
       and one for the .png save; the host turbulence fields' build time,
       each step's wall time and the card's busy time;
     - the RAW path (written from a seed, 6000x4000, a 24 MP sensor): four
       DNGs (16-bit strips with per-site black levels, AsShotNeutral,
       ColorMatrix1 and an ActiveArea; deflate tiles with predictor 2;
       lossless-JPEG tiles; LZW strips), a CR2 (lossless JPEG in Canon
       slices, SensorInfo, ColorData), a 14-bit packed NEF, an ARW and an
       RW2: each file's load timed by sub-stage (the native decode, upload,
       the develop stage on the card, download, the host's matrix, sRGB
       encode and u8 step) with the card's busy share, its develop stage
       held against the CPU's; the native LZW decode against the pure one
       on 1 MiB; the headline script through the serial CLI (-f jpeg on
       half the files, -f tiff on the other half), the spatial script
       under --shard (the NEF and a 1920x1080 DNG: two shape buckets) and
       --animate to GIF over four 1920x1080 RAW frames, each file equal to
       the same run's with --device cpu; exactly one K-blur an image
       serially and one K-blur, K-median and K-warp a shape bucket under
       --shard;
     - the tools path: a six-layer 3840x2160 .pfe with a u16 deep layer
       through Project.open, then tool_steps on the active layer: three
       lassos (replace, add, intersect), seven brush lines of about 2,000
       px under the selection (soft, pencil, eraser, Dodge, Burn, Sponge,
       scatter with hue and brightness jitter), a stock-tip stroke rotated
       30 degrees, a solid and a dashed, double-arrowed Bézier, five shapes
       (a rounded rect, a star outline, a heart, a rotated hexagon, a
       custom SVG shape), an ellipse on a new layer merged down on
       K-composite, a clone and a heal stroke, PatchMatch and five
       instant-brush dabs in a 128x128 hole, and the perspective crop;
       each stroke drawn into the canvas preview on the card, shown
       through the dirty-rect composite (K-composite) and committed as one
       PixelPatch with the deep buffer synced, every document, deep
       buffer, history entry and displayed composite held against the
       same steps run with device="cpu" after each step; undo to the
       start, redo to the end, flatten, Project.save to .pfe and .png
       (bytes equal to the CPU run's); exactly one K-composite launch a
       raster run of each display, one for the merge down, one a raster
       run of the flatten and one for the .png save, no other kernel;
       each step's wall time (untraced), the stamps of each stroke and a
       soft line's stamps a second untraced and device operations traced;
     - the server path: the serving daemon (serve_tcp on --device cuda) on
       a thread of this process, jobs over TCP on the files the earlier
       phases wrote (the headline, spatial and effects scripts on their
       serial 4K PNGs, the six-layer 4K .pfe to PNG and to .pfe, a 24 MP
       DNG to JPEG), each output byte-equal to that phase's serial CLI
       file: each kind once, then from one client (traced), then from two
       clients at once; a missing input and a line of bad JSON fail and
       the next job runs; ping's jobs_done and every launch exact;
       shutdown within 10 s; a daemon in a process of its own (seconds to
       serving, first and second job); then on a 4K layer of a Project on
       the card: a numpy plugin behind a trust list (equal to 255 - x on
       RGB), an untrusted one refused and an unresponsive one killed at
       1 s, the background remover with a deterministic fake session at
       320 and 1024 against device="cpu", and StageTimer over a K-blur
       call against its CUDA events;
     - the multi-GPU path (parallel/{mesh,distributed,spatial}): one
       16384x16384 canvas (the reference's 256-Mpix document cap) made on
       the card from a seed, row-split over meshes of 2, 4 and 8 entries
       (cuda:0 repeated on a machine with one card), through
       fused_chain_spatial, median_spatial, warp_spatial (both modes),
       composite_spatial (five layers) and process_spatial (K-blur, and a
       blur, brightness/contrast, sepia chain) with the halo exchange;
       fused_chain_grid on a 2x4 ('batch', 'rows') mesh over four
       3840x2160 frames; a ragged 2159-row image and one call on the
       single-device route; each result byte-equal to the same kernel on
       one device, one launch a mesh entry (the single-device route one);
       each call's wall time sharded and on one device, the halo rows and
       the peak device memory; then the batch CLI in two processes wired
       by PAINTFE_COORDINATOR (gloo) on the headline --shard inputs, each
       file equal to the single-process run's, a corrupt input in process
       1's share (both exit 1) and partial wiring (rc 1); then the
       cross-process phase: two processes wired the same way, each
       holding four cuda:0 entries of one 8-entry global rows mesh and
       making the same inputs from one seed, through every spatial call
       at 16384x16384, fused_chain_grid over four 3840x2160 frames on
       both 2-D layouts (a 'batch' row a process, and the rows across
       both) and one call on the single-device route; process 0's result
       byte-equal to the single-device kernel, process 1's None, one
       launch an owned entry in each process (none in process 1 on the
       single-device route); each call's wall time against one process
       on 8 entries, the bytes and seconds of the gather, each process's
       peak device memory;
     - gaussian_blur_pallas, K-pass's one entry point (no CLI path calls
       it), on a flattened 3840x2160 result: exactly two K-pass launches
       and no other kernel;
     each output must equal the same steps run through the plain versions
     on the card, each kernel of the path must have launched, and each
     kernel must have launched exactly as often as the path needs (a
     --shard bucket that fell back to the per-image path would launch its
     kernels once per image; K-composite launches once per raster run);
  4. times K-median at several radii, K-blur at several sigmas (one frame
     and a batch), K-chain, K-composite over stack depths, conceal masks
     and mode mixes, K-pass at several sigmas along both axes, and K-warp
     in both modes on a smooth and a random field (one frame and a batch,
     beside F.grid_sample), then
     each kernel beside its plain version at
     3840x2160 and beside one PyTorch call computing the same function
     where there is one, and each route beside its neighbour at the radii
     where ops/kernels.py hands over: CUDA events around one call, median
     of 15 samples after warm-up; then each effect op and each menu op at
     3840x2160 (median of 7).

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}.  Any failed
check exits non-zero before that line.  It imports nothing of JAX.

    python3 chip_smoke.py --cases

runs only the timed cases of step 4 and the flatten of one 3840x2160
document, and prints them as one JSON line: run from two checkouts in
turns, it compares two versions of the package on one card.

    python3 chip_smoke.py --spatial-process DIR

is one process of the cross-process phase (spatial_process); the smoke
starts two, wired by PAINTFE_COORDINATOR / PAINTFE_NUM_PROCESSES /
PAINTFE_PROCESS_ID.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

UHD = (2160, 3840)
FHD = (1080, 1920)
HEADLINE = ("apply_blur(2.0); apply_brightness_contrast(10.0, 20.0); "
            "apply_levels(10.0, 245.0, 1.1); apply_sepia(0.5);")
SPATIAL = ("apply_blur(2.0); apply_median(2); apply_bulge(0.5); "
           "apply_levels(10.0, 245.0, 1.1);")
# rotate_canvas_180 and flip_canvas_horizontal queue canvas ops that the CLI
# replays on the other layers
LAYERED = "apply_blur(2.0); rotate_canvas_180(); flip_canvas_horizontal();"
# the effects path: each of the 13 effect ops of the script API once, the two
# that binarize (ink, halftone) last; K-blur under sharpen and glow, K-warp
# under twist
EFFECTS = ("apply_box_blur(2); apply_motion_blur(30.0, 4.0); apply_sharpen(1.2); "
           "apply_reduce_noise(25.0); apply_noise(20.0, true); apply_pixelate(3); "
           "apply_crystallize(6); apply_twist(45.0); apply_glow(3.0, 0.6); "
           "apply_vignette(0.5, 0.9); apply_oil_painting(3); apply_ink(40.0, 20.0); "
           "apply_halftone(6.0);")
EFFECT_OPS = [("apply_box_blur", (2.0,)), ("apply_motion_blur", (30.0, 4.0)),
              ("apply_sharpen", (1.2,)), ("apply_reduce_noise", (25.0,)),
              ("apply_noise", (20.0, True)), ("apply_pixelate", (3,)),
              ("apply_crystallize", (6.0,)), ("apply_twist", (45.0,)),
              ("apply_glow", (3.0, 0.6)), ("apply_vignette", (0.5, 0.9)),
              ("apply_oil_painting", (3,)), ("apply_ink", (40.0, 20.0)),
              ("apply_halftone", (6.0,))]
# a layered document resized: resize_image on the active layer in the
# script, both canvas ops replayed on the others, then the flatten
DOC_RESIZE = 'resize_image(1920, 1080, "lanczos3"); resize_canvas(2000, 1200, "center");'
SHAPES = [(37, 53), (257, 511), UHD]
OPACITIES = (0.0, 0.37, 1.0, 1.5)
TIMED_RUNS = 15
# a timed call of over LONG_CALL_MS (K-median r = 110, 2.4 s) takes
# LONG_RUNS samples after one warm-up call
LONG_CALL_MS = 500.0
LONG_RUNS = 3
# 3840x2160 PNGs of the headline and spatial paths: serial, and --shard
# (beside two 1920x1080 ones); the effects path's (cut from 2, 4 and 3 to
# make room for the inputs path)
SERIAL_UHD = 1
SHARD_UHD = 2
EFFECTS_SERIAL_UHD = 2
EFFECTS_SHARD_UHD = 2
# K-median's timed radii at 3840x2160 (r = 40 and 110: its staged and
# global counting routes), and K-blur's timed sigmas, one frame and a batch
# of BATCH frames (sigma 60, r = 180: the split route)
MEDIAN_RADII = (1, 2, 3, 4, 8, 40, 110)
BLUR_SIGMAS = (0.5, 2.0, 8.0, 25.0, 60.0)
BATCH = 4
# K-composite's timed stacks: layers, with and without a conceal mask on
# every layer; K-pass's timed sigmas, along W = 3840 and along W = 2160
COMPOSITE_DEPTHS = (1, 4, 8)
PASS_SIGMAS = (0.5, 2.0, 8.0, 25.0)
# the timed stack of time_kernels: NORMAL, MULTIPLY, SOFT_LIGHT, SCREEN
TIMED_MODES, TIMED_OPACITIES = (0, 1, 16, 2), (1.0, 0.7, 1.0, 0.37)
# f32 operations of each mode's mixer a channel (core/blend.py), for the
# modes the timed stacks use
MIXER_OPS = {0: 0, 1: 1, 2: 4, 7: 3, 16: 9, 19: 2, 21: 5}
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): HBM, and
# f32 without FMA contraction — every kernel builds with -fmad=false, so a
# multiply and an add are two instructions: 132 SMs x 128 lanes x 1.98 GHz
F32_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
# byte operations of the CUDA cores' packed-integer pipe: 16.7e12 INT32
# instructions a second (132 SMs x 64 lanes x 1.98 GHz), four bytes each
PACKED_BYTE_OPS_PER_S = 66.9e12


def _median_checks():
    """K-median checks, (shape, radius): every network radius and the first
    counting one, on shapes that are not a multiple of the 128 x 16 tile and
    on images smaller than the window; r = 40 takes the staged route and
    r = 110 the global one."""
    from paintfe_tpu_torch.ops.kernels import MEDIAN_NETWORK_MAX_R

    net = range(1, MEDIAN_NETWORK_MAX_R + 2)
    return ([(shape, r) for shape in [(37, 53), (257, 511)] for r in net]
            + [(UHD, r) for r in (1, 2, 4)]
            + [(shape, r) for shape in [(1, 1), (2, 7), (5, 3)]
               for r in (1, MEDIAN_NETWORK_MAX_R, MEDIAN_NETWORK_MAX_R + 1)]
            + [((257, 511), 40), ((37, 53), 110)])


def _blur_limit_sigmas():
    """Sigmas whose radius meets each limit of K-blur's tile geometry: the
    last radius of the short tile and the first of the long one, the last
    radius whose source rows are staged at once and the first staged in
    chunks, the last tiled radius and the first split one."""
    from paintfe_tpu_torch.ops.kernels import (BLUR_SHORT_MAX_R, BLUR_TILE_H,
                                               blur_chunk_rows, blur_tile_rows)

    radii = range(0, 300)
    chunked = next(r for r in radii if blur_chunk_rows(BLUR_TILE_H, r) < BLUR_TILE_H + 2 * r)
    split = next(r for r in radii if blur_tile_rows(r) == 0)
    # ceil(3 * (r - 0.5) / 3) == r
    return [(r - 0.5) / 3 for r in (BLUR_SHORT_MAX_R, BLUR_SHORT_MAX_R + 1, chunked - 1,
                                    chunked, split - 1, split)]


class CheckFailed(Exception):
    pass


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise CheckFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def _wrappers():
    """Each kernel's wrapper, by the name the JSON line gives it."""
    from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import (composite_stack_kernel,
                                               gaussian_blur_fused,
                                               gaussian_blur_pass, median_kernel)
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    return {"gaussian_blur_fused": gaussian_blur_fused,
            "fused_chain_kernel": fused_chain_kernel,
            "median_kernel": median_kernel,
            "gather_bilinear_u8": gather_bilinear_u8,
            "composite_stack_kernel": composite_stack_kernel,
            "gaussian_blur_pass": gaussian_blur_pass}


def _counts():
    from paintfe_tpu_torch.utils.cuda_build import LAUNCH_LOCK

    with LAUNCH_LOCK:
        return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_counts():
    from paintfe_tpu_torch.utils.cuda_build import LAUNCH_LOCK

    with LAUNCH_LOCK:
        for fn in _wrappers().values():
            fn.launches = 0


def _rand(gen, shape, device):
    import torch

    return torch.randint(0, 256, tuple(shape) + (4,), generator=gen,
                         dtype=torch.uint8, device="cpu").to(device)


def _max_err(a, b):
    if not a.numel():
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max().item())
    return int((a.int() - b.int()).abs().max().item())


def _compare(name, got, want, errs, quiet=False):
    import torch

    torch.cuda.synchronize()
    err = _max_err(got, want) if got.shape == want.shape else 256
    errs.append(err)
    if got.shape != want.shape or not torch.equal(got, want):
        where = ""
        if got.shape == want.shape:
            bad = (got != want).nonzero()
            first = tuple(bad[0].tolist())
            where = (f", {bad.shape[0]} bytes differ, first at {first}: "
                     f"{got[first[:-1]].tolist()} vs {want[first[:-1]].tolist()}")
        raise CheckFailed(f"{name}: kernel differs from its plain version "
                          f"(max abs err {err}, shapes {tuple(got.shape)} "
                          f"vs {tuple(want.shape)}{where})")
    if not quiet:
        print(f"  ok  {name}")


def check_blur(dev, gen, errs):
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.kernels import (blur_tile_rows, gaussian_blur_fused,
                                               gaussian_blur_plain)

    print("K-blur vs gaussian_blur_plain (byte-equal):")
    for shape in [(37, 53), (257, 511), UHD]:
        img = _rand(gen, shape, dev)
        for sigma in (0.5, 2.0, 8.0, 25.0, 60.0):
            _compare(f"sigma={sigma} {shape[1]}x{shape[0]}",
                     gaussian_blur_fused(img, sigma),
                     gaussian_blur_plain(img, sigma), errs)
    # radius 240 (split route), and the radii at each tile-geometry limit
    for shape in [(37, 53), (257, 511)]:
        img = _rand(gen, shape, dev)
        for sigma in [80.0] + _blur_limit_sigmas():
            r = len(gaussian_kernel(sigma)) // 2
            th = blur_tile_rows(r)
            _compare(f"sigma={sigma:.4f} r={r} ({f'{th}-row tile' if th else 'split'}) "
                     f"{shape[1]}x{shape[0]}", gaussian_blur_fused(img, sigma),
                     gaussian_blur_plain(img, sigma), errs)
    batch = _rand(gen, (4,) + UHD, dev)
    for sigma in (2.0, 25.0):
        _compare(f"sigma={sigma} batch [4,2160,3840,4]",
                 gaussian_blur_fused(batch, sigma),
                 gaussian_blur_plain(batch, sigma), errs)


def _overlay(gen, shape, dev):
    ov = _rand(gen, shape, dev)
    ov[: max(shape[0] // 8, 1), :, 3] = 0  # clear-alpha rows pass the base
    ov[-2:, :, 3] = 255
    return ov


def _chain_limit_sigmas():
    """Sigmas whose radius takes each of K-chain's tile widths (4 sums a
    thread up to BLUR_SHORT_MAX_R, 8 above), its last tiled radius and the
    first past it (K-blur's tile, then the tail alone), and K-blur's last
    tiled radius and its first split one."""
    from paintfe_tpu_torch.ops.kernels import (BLUR_SHORT_MAX_R, blur_tile_rows,
                                               chain_tile_rows)

    radii = range(0, 300)
    chain = next(r for r in radii if chain_tile_rows(r) == 0)
    split = next(r for r in radii if blur_tile_rows(r) == 0)
    return [(r - 0.5) / 3 for r in (1, BLUR_SHORT_MAX_R, BLUR_SHORT_MAX_R + 1, chain - 1,
                                    chain, split - 1, split)]


# K-chain's opacities: the headline's, div3's limit (2^-20, the shared
# reciprocal) and the one below it (three correctly rounded divides), full
CHAIN_OPACITIES = (0.6, 2.0 ** -20, 2.0 ** -21, 1.0)


def _div_counts(entry, *args):
    """Run one of the exhaustive quotient counts (pfe_composite_div_check,
    pfe_chain_div_check) and return (differing, compared)."""
    import torch

    from paintfe_tpu_torch.utils.cuda_build import check, load_library

    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    check(getattr(load_library(), entry)(*args, counts.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream), entry)
    return tuple(counts.tolist())


def check_chain(dev, gen, errs):
    import ctypes

    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import blur_sums, chain_tile_rows

    print("K-chain vs plain fused_chain (byte-equal):")
    for shape in [(130, 201), UHD]:
        img = _rand(gen, shape, dev)
        img[shape[0] // 2: shape[0] // 2 + 3, :, 3] = 0  # clear base rows
        ov = _overlay(gen, shape, dev)
        for sigma in (2.0, 25.0, 60.0):
            _compare(f"sigma={sigma} {shape[1]}x{shape[0]}",
                     fused_chain_kernel(img, ov, sigma=sigma),
                     fused_chain(img, ov, sigma=sigma), errs)
    img = _rand(gen, (130, 201), dev)
    ov = _overlay(gen, (130, 201), dev)
    _compare("sigma=80 (K-blur + tail route) 201x130",
             fused_chain_kernel(img, ov, sigma=80.0),
             fused_chain(img, ov, sigma=80.0), errs)
    # each tile width and route limit, at every opacity of CHAIN_OPACITIES
    img[40:43, :, 3] = 0
    for sigma in _chain_limit_sigmas():
        r = len(gaussian_kernel(sigma)) // 2
        th = chain_tile_rows(r)
        route = f"{blur_sums(r)} sums x {th}-row tile" if th else "K-blur + tail"
        for opacity in CHAIN_OPACITIES:
            _compare(f"sigma={sigma:.4f} r={r} ({route}) opacity={opacity:g} 201x130",
                     fused_chain_kernel(img, ov, sigma=sigma, blend_opacity=opacity),
                     fused_chain(img, ov, sigma=sigma, blend_opacity=opacity), errs)
    img = _rand(gen, UHD, dev)
    ov = _overlay(gen, UHD, dev)
    for opacity in (2.0 ** -20, 2.0 ** -21):
        _compare(f"sigma=2.0 opacity={opacity:g} 3840x2160",
                 fused_chain_kernel(img, ov, blend_opacity=opacity),
                 fused_chain(img, ov, blend_opacity=opacity), errs)
    # the tail's quotients against __fdiv_rn over every u8 input, dispatched
    # as the chain dispatches (div3 at 2^-20 and above)
    differ = compared = 0
    for opacity in CHAIN_OPACITIES:
        d, c = _div_counts("pfe_chain_div_check", ctypes.c_float(opacity))
        differ, compared = differ + d, compared + c
    print(f"  chain's soft-light quotients against __fdiv_rn, every u8 (base, base alpha, "
          f"overlay, overlay alpha), opacities {CHAIN_OPACITIES}: {differ} of {compared} "
          "differ")
    if differ or not compared:
        raise CheckFailed("K-chain's quotients differ from __fdiv_rn")


def check_median(dev, gen, errs):
    import torch

    from paintfe_tpu_torch.ops.kernels import median_kernel, median_plain, median_route

    print("K-median vs median_plain (byte-equal):")
    for shape, r in _median_checks():
        img = _rand(gen, shape, dev)
        _compare(f"r={r} ({median_route(r)} route) {shape[1]}x{shape[0]}",
                 median_kernel(img, r), median_plain(img, r), errs)
        del img
        torch.cuda.empty_cache()
    batch = _rand(gen, (4,) + UHD, dev)
    _compare(f"r=2 batch [4,{UHD[0]},{UHD[1]},4]", median_kernel(batch, 2),
             median_plain(batch, 2), errs)


def _warp_fields(gen, h, w, dev):
    import torch

    from paintfe_tpu_torch.ops.effects.distort import bulge_field

    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    bx, by, _ = bulge_field(0.5, (0.5, 0.5), h, w, dev)
    fields = {
        "identity": (xs, ys),
        "constant shift": (xs - 7.25, ys + 3.5),
        "bulge 0.5": (bx, by),
        # reaches up to 64 px outside the source on every side
        "random, out of source": (
            torch.rand((h, w), generator=gen) * (w + 128) - 64,
            torch.rand((h, w), generator=gen) * (h + 128) - 64),
    }
    return {k: (x.contiguous().to(dev), y.contiguous().to(dev))
            for k, (x, y) in fields.items()}


def _field_offset(t, offset):
    """A contiguous copy of the f32 tensor `t` whose first byte lies
    `offset` bytes (a multiple of 4) past a 16-byte boundary."""
    import torch

    flat = torch.empty(t.numel() + 8, dtype=torch.float32, device=t.device)
    start = (-flat.data_ptr()) % 16 // 4 + offset // 4
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == offset % 16 and out.is_contiguous()
    return out


def check_warp(dev, gen, errs):
    import torch

    from paintfe_tpu_torch.ops.warp_kernel import (gather_bilinear_plain,
                                                   gather_bilinear_u8, warp_split)

    print("K-warp vs gather_bilinear_plain (byte-equal):")

    def path(sx, sy, w):
        kind, _, tail = warp_split(w, sx.data_ptr(), sy.data_ptr(), 0)
        return f"{kind} path" + (f", tail of {tail}" if tail else "")

    for shape in [(257, 511), UHD, (UHD[0], UHD[1] - 2), (UHD[0], UHD[1] + 1)]:
        src = _rand(gen, shape, dev)
        for name, (sx, sy) in _warp_fields(gen, *shape, dev).items():
            for mode in ("zero", "clamp"):
                _compare(f"{mode} {name} {shape[1]}x{shape[0]} ({path(sx, sy, shape[1])})",
                         gather_bilinear_u8(src, sx, sy, mode),
                         gather_bilinear_plain(src, sx, sy, mode), errs)
        del src
        torch.cuda.empty_cache()
    # the 4K fields 4 and 8 bytes off a 16-byte boundary: the scalar path
    src = _rand(gen, UHD, dev)
    for name, (sx, sy) in _warp_fields(gen, *UHD, dev).items():
        for fx, fy, how in ((_field_offset(sx, 4), sy, "sx 4 bytes off"),
                            (sx, _field_offset(sy, 8), "sy 8 bytes off")):
            for mode in ("zero", "clamp"):
                _compare(f"{mode} {name} {UHD[1]}x{UHD[0]}, {how} ({path(fx, fy, UHD[1])})",
                         gather_bilinear_u8(src, fx, fy, mode),
                         gather_bilinear_plain(src, fx, fy, mode), errs)
    for shape in [(3, 257, 511), (4,) + UHD, (2, UHD[0], UHD[1] + 1)]:  # one field, a batch
        batch = _rand(gen, shape, dev)
        sx, sy = _warp_fields(gen, *shape[1:], dev)["bulge 0.5"]
        _compare(f"clamp bulge batch [{','.join(map(str, shape))},4] "
                 f"({path(sx, sy, shape[2])})",
                 gather_bilinear_u8(batch, sx, sy, "clamp"),
                 gather_bilinear_plain(batch, sx, sy, "clamp"), errs)
        del batch
        torch.cuda.empty_cache()


def _composite_inputs(gen, n, shape, dev):
    """n random layers (clear, opaque and mixed alpha rows), conceal masks
    (rows of 0 and 255 among random ones) and an initial accumulator."""
    import torch

    layers = _rand(gen, (n,) + tuple(shape), dev)
    layers[:, 0::7, :, 3] = 0
    layers[:, 1::7, :, 3] = 255
    conceal = torch.randint(0, 256, (n,) + tuple(shape), generator=gen,
                            dtype=torch.uint8).to(dev)
    conceal[:, 2::5] = 0
    conceal[:, 3::5] = 255
    return layers, conceal, _rand(gen, shape, dev)


def check_composite(dev, gen, errs):
    import torch

    from paintfe_tpu_torch.ops.kernels import (COMPOSITE_CHUNK,
                                               composite_stack_kernel,
                                               composite_stack_plain)

    print("K-composite vs composite_stack_plain (byte-equal):")
    variants = (("", False, False), (" +conceal", True, False),
                (" +init", False, True), (" +conceal +init", True, True))
    for shape in SHAPES:
        # every mode at every opacity, over a NORMAL base, under SOFT_LIGHT
        layers, conceal, init = _composite_inputs(gen, 3, shape, dev)
        checks = 0
        for mode in range(25):
            for opacity in OPACITIES:
                modes, opac = (0, mode, 16), (1.0, opacity, 0.6)
                for name, c, i in variants:
                    c, i = (conceal if c else None), (init if i else None)
                    _compare(f"mode {mode} opacity {opacity}{name} "
                             f"{shape[1]}x{shape[0]}",
                             composite_stack_kernel(layers, modes, opac, c, i),
                             composite_stack_plain(layers, modes, opac, c, i),
                             errs, quiet=True)
                    checks += 1
        print(f"  ok  25 modes x opacities {OPACITIES} x conceal/init, N=3, "
              f"{shape[1]}x{shape[0]} ({checks} checks)")
        del layers, conceal, init
        # 1, 6 and more layers than one launch folds, cycling the modes
        for n in (1, 6, COMPOSITE_CHUNK + 8):
            layers, conceal, init = _composite_inputs(gen, n, shape, dev)
            modes = [(7 * k + 3) % 25 for k in range(n)]
            opac = [OPACITIES[k % 4] for k in range(n)]
            for name, c, i in variants:
                c, i = (conceal if c else None), (init if i else None)
                _compare(f"N={n}{name} {shape[1]}x{shape[0]}",
                         composite_stack_kernel(layers, modes, opac, c, i),
                         composite_stack_plain(layers, modes, opac, c, i), errs)
            del layers, conceal, init
            torch.cuda.empty_cache()


def _offset_copy(t, offset):
    """A contiguous copy of `t` whose first byte lies `offset` bytes past a
    16-byte boundary."""
    import torch

    flat = torch.empty(t.numel() * t.element_size() + 32, dtype=torch.uint8, device=t.device)
    start = (-flat.data_ptr()) % 16 + offset
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == offset % 16 and out.is_contiguous()
    return out


def check_composite_paths(dev, gen, errs):
    """K-composite's entry picks the 16-byte path only where every pointer
    of the launch allows it.  Layers allocated one by one take it (with a
    scalar tail where H * W is not a multiple of 4); a layer, the initial
    accumulator or the result's neighbours 4 or 8 bytes off a 16-byte
    boundary, or a conceal plane 1 byte off, take the scalar path.  Then the
    exact-divide route (opacities below 2^-20), and the shared reciprocal
    counted against __fdiv_rn over every u8 input."""
    import ctypes

    from paintfe_tpu_torch.ops.kernels import (composite_stack_kernel,
                                               composite_stack_plain)

    print("K-composite vector path, scalar path and scalar tail (byte-equal):")
    modes = [0, 1, 16, 7, 13, 14, 21, 2]
    opac = [1.0, 0.7, 1.0, 0.37, 0.5, 0.9, 1.0, 0.2]
    for shape in [(37, 53), (64, 64), (257, 511), (1, 1), (1, 3), (2, 2)]:
        stacked, conceal, init = _composite_inputs(gen, len(modes), shape, dev)
        want = composite_stack_plain(stacked, modes, opac, conceal, init)
        aligned = [l.clone() for l in stacked]
        masks = [m.clone() for m in conceal]
        cases = {
            "layers allocated singly (vector path"
            + (", scalar tail)" if shape[0] * shape[1] % 4 else ")"): (aligned, masks, init),
            "one layer 4 bytes off (scalar path)":
                (aligned[:3] + [_offset_copy(aligned[3], 4)] + aligned[4:], masks, init),
            "one conceal plane 1 byte off (scalar path)":
                (aligned, masks[:2] + [_offset_copy(masks[2], 1)] + masks[3:], init),
            "the accumulator 8 bytes off (scalar path)":
                (aligned, masks, _offset_copy(init, 8)),
            "a stacked tensor unbound": (stacked, conceal, init),
        }
        for name, (ls, ms, ini) in cases.items():
            _compare(f"{name} {shape[1]}x{shape[0]}",
                     composite_stack_kernel(ls, modes, opac, ms, ini), want, errs)
    # opacities below 2^-20 take three __fdiv_rn a pixel
    stacked, conceal, init = _composite_inputs(gen, 4, (257, 511), dev)
    for mode in (0, 7, 13, 16):
        for tiny in (9.5e-7, 1e-12, 1e-30, 1e-45):
            ms, op = (0, mode, mode, 2), (1.0, tiny, 1.0, tiny)
            _compare(f"mode {mode} opacity {tiny} (exact divides) 511x257",
                     composite_stack_kernel(stacked, ms, op, conceal, init),
                     composite_stack_plain(stacked, ms, op, conceal, init), errs, quiet=True)
    print("  ok  opacities below 2^-20 (exact divides), 4 modes x 4 opacities")
    differ = compared = 0
    for mode in (0, 1, 7, 16, 19, 21):
        for opacity in (1.0, 0.37, 2.0 ** -20):
            d, c = _div_counts("pfe_composite_div_check", mode, ctypes.c_float(opacity))
            differ, compared = differ + d, compared + c
    print(f"  shared reciprocal against __fdiv_rn, every u8 (base, base alpha, top, top "
          f"alpha), 6 modes x 3 opacities: {differ} of {compared} quotients differ")
    if differ or not compared:
        raise CheckFailed("K-composite's shared reciprocal differs from __fdiv_rn")
    errs.append(0)


def _plain_blur_pallas(img, sigma):
    """gaussian_blur_pallas through K-pass's plain version."""
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_pass_plain
    from paintfe_tpu_torch.utils.quant import round_u8

    taps = gaussian_kernel(sigma)
    hbuf = gaussian_blur_pass_plain(img.float().permute(2, 0, 1).contiguous(), taps)
    vbuf = gaussian_blur_pass_plain(hbuf.transpose(1, 2).contiguous(), taps)
    return round_u8(vbuf.permute(2, 1, 0))


def check_blur_pass(dev, gen, errs):
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.kernels import (gaussian_blur_pallas,
                                               gaussian_blur_pass,
                                               gaussian_blur_pass_plain)

    print("K-pass vs gaussian_blur_pass_plain (byte-equal):")
    for shape in SHAPES:
        img = _rand(gen, shape, dev)
        planar = img.float().permute(2, 0, 1).contiguous()
        for sigma in (0.5, 2.0, 8.0, 25.0):
            taps = gaussian_kernel(sigma)
            _compare(f"one pass sigma={sigma} f32 [4,{shape[0]},{shape[1]}]",
                     gaussian_blur_pass(planar, taps),
                     gaussian_blur_pass_plain(planar, taps), errs)
            _compare(f"gaussian_blur_pallas sigma={sigma} {shape[1]}x{shape[0]}",
                     gaussian_blur_pallas(img, sigma), _plain_blur_pallas(img, sigma),
                     errs)
    # widths below the radius, around a group of 4 and around a segment, on
    # the staged route (the wrapper's) and the global one (forced)
    import torch

    from paintfe_tpu_torch.ops.kernels import PASS_MAX_SEG, pass_route, pass_segment
    from paintfe_tpu_torch.utils.cuda_build import check, load_library

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    widths = [1, 2, 3, 4, 5, 7, 8, 63, PASS_MAX_SEG - 1, PASS_MAX_SEG, PASS_MAX_SEG + 1,
              2 * PASS_MAX_SEG + 3]
    for w in widths:
        x = (torch.rand((3, 5, w), generator=gen) * 300 - 20).to(dev)
        for sigma in (0.5, 2.0, 8.0, 25.0):
            taps = gaussian_kernel(sigma)
            want = gaussian_blur_pass_plain(x, taps)
            _compare(f"W={w} sigma={sigma}", gaussian_blur_pass(x, taps), want, errs,
                     quiet=True)
            forced = torch.empty_like(x)
            check(lib.pfe_blur_pass(x.data_ptr(), torch.from_numpy(taps).to(dev).data_ptr(),
                                    forced.data_ptr(), 15, w, len(taps), 0, stream),
                  "pfe_blur_pass, global route")
            _compare(f"W={w} sigma={sigma} global route", forced, want, errs, quiet=True)
    if any(pass_route(w, 75) != "staged" for w in widths):
        raise CheckFailed("K-pass: a checked width left the staged route")
    print(f"  ok  widths {widths} (segments of {[pass_segment(w) for w in widths]}) x "
          "sigmas (0.5, 2, 8, 25), f32 [3,5,W], staged and global routes")


def _plain_headline(img):
    """The headline script's steps through the plain versions."""
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_plain
    from paintfe_tpu_torch.parallel.pipeline import (_bc_device, _levels_device,
                                                     _sepia_device)

    x = gaussian_blur_plain(img, 2.0)
    x = _bc_device(x, 10.0, 20.0)
    x = _levels_device(x, 10.0, 245.0, 1.1)
    return _sepia_device(x, 0.5)


def _plain_spatial(img):
    """The spatial-effects script's steps through the plain versions."""
    import torch

    from paintfe_tpu_torch.ops.effects.distort import bulge_field
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_plain, median_plain
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_plain
    from paintfe_tpu_torch.parallel.pipeline import _levels_device

    x = gaussian_blur_plain(img, 2.0)
    x = median_plain(x, 2)
    sx, sy, norm = bulge_field(0.5, (0.5, 0.5), x.shape[0], x.shape[1], x.device)
    x = torch.where((norm >= 1.0)[..., None], x,
                    gather_bilinear_plain(x, sx, sy, "clamp"))
    return _levels_device(x, 10.0, 245.0, 1.1)


@contextlib.contextmanager
def _plain_kernels():
    """Route K-blur's and K-warp's wrappers through their plain versions
    (the ops import them from their modules at each call)."""
    import paintfe_tpu_torch.ops.kernels as kernels
    import paintfe_tpu_torch.ops.warp_kernel as warp_kernel

    blur, warp = kernels.gaussian_blur_fused, warp_kernel.gather_bilinear_u8
    kernels.gaussian_blur_fused = kernels.gaussian_blur_plain
    warp_kernel.gather_bilinear_u8 = warp_kernel.gather_bilinear_plain
    try:
        yield
    finally:
        kernels.gaussian_blur_fused, warp_kernel.gather_bilinear_u8 = blur, warp


def _plain_effects(img):
    """The effects script's steps on the card, gaussian_blur_plain and
    gather_bilinear_plain standing in for K-blur and K-warp."""
    from paintfe_tpu_torch.parallel.pipeline import compile_pipeline, trace_script

    with _plain_kernels():
        return compile_pipeline(trace_script(EFFECTS))(img)


# ---------------------------------------------------------------------------
# Input writers of the inputs path (tests/test_torch_deep_io.py and
# tests/test_torch_pdn.py use them too): 16-bit PNGs whose rows take every
# PNG filter, and Paint.NET .pdn documents
# ---------------------------------------------------------------------------


def _png_chunk(tag, payload):
    import struct
    import zlib

    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def png16_bytes(pixels, filters=(0, 1, 2, 3, 4), level=1):
    """A 16-bit RGB or RGBA PNG (u16 [H, W, 3 or 4]) whose row y takes PNG
    filter filters[y % len(filters)], encoded with numpy (each filter
    predicts from the unfiltered bytes, so every row encodes at once)."""
    import struct
    import zlib

    import numpy as np

    h, w, ch = pixels.shape
    bpp = 2 * ch
    data = np.ascontiguousarray(pixels, ">u2").view(np.uint8).reshape(h, w * bpp)
    line = data.astype(np.int16)
    prev = np.zeros_like(line)
    prev[1:] = line[:-1]
    a = np.zeros_like(line)
    a[:, bpp:] = line[:, :-bpp]
    c = np.zeros_like(line)
    c[:, bpp:] = prev[:, :-bpp]
    kinds = np.asarray(filters, np.uint8)[np.arange(h) % len(filters)]
    raw = np.empty((h, w * bpp + 1), np.uint8)
    raw[:, 0] = kinds
    for f in range(5):
        rows = kinds == f
        if not rows.any():
            continue
        la, lb, lc = a[rows], prev[rows], c[rows]
        if f == 0:
            pred = np.zeros_like(la)
        elif f == 1:
            pred = la
        elif f == 2:
            pred = lb
        elif f == 3:
            pred = (la + lb) >> 1
        else:
            pa, pb, pc = np.abs(lb - lc), np.abs(la - lc), np.abs(la + lb - 2 * lc)
            pred = np.where((pa <= pb) & (pa <= pc), la, np.where(pb <= pc, lb, lc))
        raw[rows, 1:] = ((line[rows] - pred) & 0xFF).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 6 if ch == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def _lp(s):
    """An MS-NRBF length-prefixed string (7-bit encoded length)."""
    b = s.encode()
    n, out = len(b), bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out) + b


def pdn_bytes(layers, width, height, chunk=1 << 18, stride_pad=0, level=1):
    """A Paint.NET .pdn document of `layers`, bottom first: dicts of name,
    pixels (u8 RGBA [H, W, 4]), visible, opacity (0-255) and blend (the
    blend op's name: "Normal", "Multiply", "Screen", ...).  The container
    is the PDN3 magic, the XML header and the .NET BinaryFormatter graph
    Document -> BitmapLayer -> LayerProperties / BitmapLayerProperties
    (blendOp) / Surface -> deferred MemoryBlock, then each block's
    DeferredFormatter payload: BGRA rows at the surface stride (w * 4 +
    stride_pad), in gzip chunks of `chunk` bytes.  Each class after its
    first use is written as a ClassWithId record, as the formatter does."""
    import gzip
    import struct

    import numpy as np

    i32 = lambda v: struct.pack("<i", v)  # noqa: E731
    out = bytearray(b"\x00" + struct.pack("<iiii", 1, -1, 1, 0))  # header, root 1
    out += b"\x0c" + i32(2) + _lp("PaintDotNet.Data, Version=3.36.0.0")
    classes = {}
    next_id = [10]

    def new_id():
        next_id[0] += 1
        return next_id[0]

    def obj(name, members, values):
        """One class instance: members (name, bin type, extra), values
        already encoded in member order."""
        oid = new_id()
        if name in classes:
            rec = b"\x01" + i32(oid) + i32(classes[name])
        else:
            classes[name] = oid
            rec = b"\x05" + i32(oid) + _lp(name) + i32(len(members))
            rec += b"".join(_lp(m) for m, _, _ in members)
            rec += bytes(bt for _, bt, _ in members)
            rec += b"".join(bytes([x]) for _, bt, x in members if bt == 0)
            rec += i32(2)  # library
        return rec + b"".join(values)

    def string(s):
        return b"\x06" + i32(new_id()) + _lp(s)

    stride = width * 4 + stride_pad
    payloads = []
    items = []
    for layer in layers:
        props = obj("PaintDotNet.Layer+LayerProperties",
                    [("name", 1, None), ("visible", 0, 1), ("opacity", 0, 2)],
                    [string(layer["name"]), bytes([bool(layer.get("visible", True))]),
                     bytes([int(layer.get("opacity", 255))])])
        op = obj(f"PaintDotNet.UserBlendOps+{layer.get('blend', 'Normal')}BlendOp", [], [])
        bprops = obj("PaintDotNet.BitmapLayer+BitmapLayerProperties",
                     [("blendOp", 2, None)], [op])
        rows = np.zeros((height, stride), np.uint8)
        rows[:, :width * 4] = np.asarray(layer["pixels"], np.uint8)[..., [2, 1, 0, 3]].reshape(
            height, width * 4)
        payloads.append(rows.tobytes())
        block = obj("PaintDotNet.MemoryBlock",
                    [("length64", 0, 9), ("hasParent", 0, 1), ("deferred", 0, 1)],
                    [struct.pack("<q", height * stride), b"\x00", b"\x01"])
        surface = obj("PaintDotNet.Surface",
                      [("width", 0, 8), ("height", 0, 8), ("stride", 0, 8), ("scan0", 2, None)],
                      [i32(width), i32(height), i32(stride), block])
        items.append(obj("PaintDotNet.BitmapLayer",
                         [("Layer+properties", 2, None), ("properties", 2, None),
                          ("surface", 2, None)], [props, bprops, surface]))
    layer_list = b"\x10" + i32(new_id()) + i32(len(items)) + b"".join(items)
    doc = (b"\x05" + i32(1) + _lp("PaintDotNet.Document") + i32(3)
           + _lp("width") + _lp("height") + _lp("layers") + b"\x00\x00\x02"
           + bytes([8, 8]) + i32(2) + i32(width) + i32(height) + layer_list)
    out += doc + b"\x0b"
    for raw in payloads:  # the deferred payloads, in MemoryBlock stream order
        out += b"\x00" + struct.pack(">I", chunk)
        for k in range(0, max(len(raw), 1), chunk):
            z = gzip.compress(raw[k:k + chunk], compresslevel=level, mtime=0)
            out += struct.pack(">II", k // chunk, len(z)) + z
    xml = (f'<pdnImage width="{width}" height="{height}" layers="{len(layers)}" '
           'savedWithVersion="3.36"><custom></custom></pdnImage>').encode()
    return b"PDN3" + len(xml).to_bytes(3, "little") + xml + b"\x00\x01" + bytes(out)


def _write_inputs(d, specs, seed):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    arrays = {}
    for name, (h, w) in specs:
        a = rng.integers(0, 256, (h, w, 4), np.uint8)
        a[:128, :, 3] = 0  # fully transparent tiles, clear even after the blur
        Image.fromarray(a, "RGBA").save(d / name, compress_level=1)
        arrays[name] = a
    return arrays


def _drive_cli(dev, tmp, tag, script, plain_steps, per_image, seed,
               n_serial=SERIAL_UHD, n_shard=SHARD_UHD):
    """The serial CLI on n_serial 3840x2160 PNGs (with its per-stage times),
    then --shard on n_shard 3840x2160 and two 1920x1080 PNGs (two shape
    buckets); checks exit codes, launch counts (`per_image`: each kernel's
    launches for one image, so per serial image and per --shard bucket), the
    --shard run's peak device memory, and every output against
    `plain_steps` on the card."""
    import numpy as np
    import torch
    from PIL import Image

    from paintfe_tpu_torch import cli
    from paintfe_tpu_torch.core.canvas import canonicalize_tiles

    root = tmp / tag
    (root / "serial").mkdir(parents=True)
    (root / "shard").mkdir()
    (root / "fx.rhai").write_text(script)
    serial = _write_inputs(root / "serial",
                           [(f"s{k}.png", UHD) for k in range(n_serial)], seed)
    shard = _write_inputs(root / "shard", [(f"u{k}.png", UHD) for k in range(n_shard)]
                          + [(f"f{k}.png", FHD) for k in range(2)], seed + 1)
    argv = ["-s", str(root / "fx.rhai"), "-f", "png", "--device", "cuda"]
    c0 = _counts()
    t0 = time.perf_counter()
    # --profile: the serial run prints load / script / encode per image
    rc_serial = cli.main(["-i", str(root / "serial" / "*.png"), "--output-dir",
                          str(root / "out_serial"), "--profile", *argv])
    t1 = time.perf_counter()
    c1 = _counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc_shard = cli.main(["-i", str(root / "shard" / "*.png"), "--output-dir",
                         str(root / "out_shard"), "--shard", *argv])
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**20
    c2 = _counts()
    print(f"  {tag}: serial CLI rc {rc_serial} ({t1 - t0:.3f} s, {n_serial} x 4K), "
          f"--shard CLI rc {rc_shard} ({t2 - t1:.3f} s, {n_shard} x 4K + 2 x 1080p, "
          f"peak device memory {peak:.1f} MiB)")
    if rc_serial != 0 or rc_shard != 0:
        raise CheckFailed(f"{tag}: CLI exit codes: serial {rc_serial}, "
                          f"shard {rc_shard}")
    for name, k in per_image.items():
        n_serial_got, n_shard_got = c1[name] - c0[name], c2[name] - c1[name]
        if n_serial_got != k * n_serial:
            raise CheckFailed(f"{tag}: the serial CLI launched {name} "
                              f"{n_serial_got} times for {n_serial} images, "
                              f"expected {k * n_serial}")
        if n_shard_got != k * 2:
            raise CheckFailed(f"{tag}: --shard launched {name} {n_shard_got} times "
                              f"for 2 shape buckets, expected {k * 2}: a bucket did "
                              "not run as one batched launch")

    def expect(arr):
        return plain_steps(torch.from_numpy(arr).to(dev)).cpu().numpy()

    for name, arr in serial.items():
        got = np.asarray(Image.open(root / "out_serial" / name))
        if not np.array_equal(got, canonicalize_tiles(expect(arr))):
            raise CheckFailed(f"{tag}: serial CLI output {name} differs from "
                              "the plain steps")
    for name, arr in shard.items():
        got = np.asarray(Image.open(root / "out_shard" / name))
        if not np.array_equal(got, expect(arr)):
            raise CheckFailed(f"{tag}: --shard CLI output {name} differs from "
                              "the plain steps")
    print(f"  ok  {tag}: CLI outputs (serial {len(serial)}, --shard {len(shard)}) "
          f"equal the plain steps; launches per serial image and per --shard bucket "
          f"{per_image}")


def _check_launched(tag, counts, names):
    print(f"  {tag} launches: {counts}")
    for name in names:
        if counts[name] == 0:
            raise CheckFailed(f"{name} was not launched on the {tag} path")


def drive_main_paths(dev, gen, tmp, card):
    """The main paths (headline, spatial, layered, effects, inputs,
    document, menu, raw, tools, server, multigpu with its cross-process
    phase) and K-pass's entry call, each with launch counts from 0 (the
    cross-process phase's in its own processes).
    Returns each phase's launch counts, by phase."""
    import torch

    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel

    print("main paths (launch counts from 0 before each):")
    img = _rand(gen, UHD, dev)
    ov = _overlay(gen, UHD, dev)
    with _section("headline path"):
        _reset_counts()
        _drive_cli(dev, tmp, "headline", HEADLINE, _plain_headline,
                   {"gaussian_blur_fused": 1}, 1)
        head = fused_chain_kernel(img, ov)
        torch.cuda.synchronize()
        headline = _counts()
        _check_launched("headline", headline,
                        ("gaussian_blur_fused", "fused_chain_kernel"))
        if not torch.equal(head, fused_chain(img, ov)):
            raise CheckFailed("headline chain frame differs from the plain chain")
        print("  ok  the headline frame equals the plain chain")

    with _section("spatial path"):
        _reset_counts()
        _drive_cli(dev, tmp, "spatial", SPATIAL, _plain_spatial,
                   {"gaussian_blur_fused": 1, "median_kernel": 1, "gather_bilinear_u8": 1}, 3)
        torch.cuda.synchronize()
        spatial = _counts()
        _check_launched("spatial", spatial,
                        ("gaussian_blur_fused", "median_kernel", "gather_bilinear_u8"))

    with _section("layered path"):
        _reset_counts()
        layered = drive_layered_path(dev, tmp)

    with _section("effects path"):
        _reset_counts()
        _drive_cli(dev, tmp, "effects", EFFECTS, _plain_effects,
                   {"gaussian_blur_fused": 2, "gather_bilinear_u8": 1}, 7,
                   EFFECTS_SERIAL_UHD, EFFECTS_SHARD_UHD)
        drive_resized_document(dev, tmp)
        torch.cuda.synchronize()
        effects = _counts()
        _check_launched("effects", effects, ("gaussian_blur_fused", "gather_bilinear_u8",
                                             "composite_stack_kernel"))

    with _section("inputs path"):
        _reset_counts()
        drive_inputs_path(dev, tmp)
        torch.cuda.synchronize()
        inputs = _counts()
        _check_launched("inputs", inputs, ("gaussian_blur_fused", "composite_stack_kernel"))

    with _section("document path"):
        _reset_counts()
        document = drive_document_path(dev, tmp, card)
        _check_launched("document", document, ("gather_bilinear_u8", "composite_stack_kernel"))

    with _section("menu path"):
        _reset_counts()
        menu = drive_menu_path(dev, tmp, card)
        _check_launched("menu", menu, ("gather_bilinear_u8", "gaussian_blur_fused",
                                       "composite_stack_kernel"))

    with _section("raw path"):
        _reset_counts()
        drive_raw_path(dev, tmp, card)
        torch.cuda.synchronize()
        raw = _counts()
        _check_launched("raw", raw, ("gaussian_blur_fused", "median_kernel",
                                     "gather_bilinear_u8"))

    with _section("tools path"):
        _reset_counts()
        tools = drive_tools_path(dev, tmp, card)
        _check_launched("tools", tools, ("composite_stack_kernel",))

    with _section("server path"):
        _reset_counts()
        server = drive_server_path(dev, tmp, card)
        _check_launched("server", server, ("gaussian_blur_fused", "median_kernel",
                                           "gather_bilinear_u8", "composite_stack_kernel"))

    with _section("multigpu path"):
        multigpu, processes = drive_multigpu_path(dev, tmp, card)
        for tag, counts in (("multigpu", multigpu), ("multigpu processes", processes)):
            _check_launched(tag, counts, ("gaussian_blur_fused", "median_kernel",
                                          "gather_bilinear_u8", "composite_stack_kernel",
                                          "fused_chain_kernel"))

    entry = drive_blur_pass_entry(dev, tmp / "layered" / "out_serial" / "d0.png")
    return {"headline": headline, "spatial": spatial, "layered": layered,
            "effects": effects, "inputs": inputs, "document": document, "menu": menu,
            "raw": raw, "tools": tools, "server": server, "multigpu": multigpu,
            "multigpu processes": processes,
            "gaussian_blur_pallas entry call": entry}


# The server path's jobs, by kind: (the earlier phase's folder, its input,
# its script, the format, the file that phase's serial CLI wrote for that
# input and script); each job's kernel launches, as _drive_cli and the
# layered and RAW phases state them per image
SERVER_JOBS = {
    "headline": ("headline", "serial/s0.png", "fx.rhai", "png", "out_serial/s0.png"),
    "spatial": ("spatial", "serial/s0.png", "fx.rhai", "png", "out_serial/s0.png"),
    "effects": ("effects", "serial/s0.png", "fx.rhai", "png", "out_serial/s0.png"),
    "layered png": ("layered", "serial/d0.pfe", "fx.rhai", "png", "out_serial/d0.png"),
    "layered pfe": ("layered", "serial/d0.pfe", "fx.rhai", "pfe", "out_pfe/d0.pfe"),
    "raw": ("raw", "in/strips.dng", "headline.rhai", "jpeg", "cuda_jpeg/strips.jpg"),
}
SERVER_LAUNCHES = {
    "headline": {"gaussian_blur_fused": 1},
    "spatial": {"gaussian_blur_fused": 1, "median_kernel": 1, "gather_bilinear_u8": 1},
    "effects": {"gaussian_blur_fused": 2, "gather_bilinear_u8": 1},
    "layered png": {"gaussian_blur_fused": 1, "composite_stack_kernel": 2},
    "layered pfe": {"gaussian_blur_fused": 1},
    "raw": {"gaussian_blur_fused": 1},
}
# the jobs each of two clients sends at once, and how often (cut from three
# to keep the phase near a minute: a 4K PNG job is mostly the host's encode)
SERVER_CONCURRENT = ("headline", "spatial", "layered png")
SERVER_REPEATS = 1

# the demo plugin of the server path: invert RGB, keep alpha, in numpy (so
# a render measures the pipe and the base64, not a Python loop)
NUMPY_PLUGIN = '''import base64, json, sys
import numpy as np
for line in sys.stdin:
    req = json.loads(line)
    if req["cmd"] == "describe":
        print(json.dumps({"name": "numpy demo", "effects": [{"id": "invert", "name": "Invert"}]}),
              flush=True)
    elif req["cmd"] == "render":
        px = np.frombuffer(base64.b64decode(req["pixels_b64"]), np.uint8)
        px = px.reshape(req["height"], req["width"], 4).copy()
        px[..., :3] = 255 - px[..., :3]
        sys.stdout.write(json.dumps({"ok": True, "pixels_b64": base64.b64encode(px.tobytes())
                                     .decode()}) + "\\n")
        sys.stdout.flush()
'''


def inverted(x):
    """NUMPY_PLUGIN's invert of a u8 [H, W, 4] tensor, on its device."""
    import torch

    return torch.cat([255 - x[..., :3], x[..., 3:]], dim=-1)


class SmokeSession:
    """An ONNX-Runtime-style session for BackgroundRemover (numpy in, numpy
    out), deterministic as tests/test_ai.py's: the channel mean of the
    normalised input times 4 (logits, in the sigmoid's range), or mapped
    into [0, 1] (probabilities).  Counts its runs."""

    def __init__(self, probabilities: bool):
        self.probabilities = probabilities
        self.calls = 0

    def get_inputs(self):
        import types

        return [types.SimpleNamespace(name="input")]

    def run(self, _outputs, feeds):
        import numpy as np

        self.calls += 1
        (x,) = feeds.values()
        m = x.mean(axis=1, keepdims=True, dtype=np.float32)
        if self.probabilities:
            return [np.clip(m * np.float32(0.25) + np.float32(0.5), 0.0, 1.0).astype(np.float32)]
        return [m * np.float32(4.0)]


def _server_job(tmp, kind, out_dir):
    """The job of `kind` on the earlier phase's files, its output in out_dir."""
    folder, inp, script, fmt, _ = SERVER_JOBS[kind]
    d = tmp / folder
    ext = {"jpeg": "jpg"}.get(fmt, fmt)
    return {"input": str(d / inp), "script": str(d / script), "format": fmt,
            "output": str(out_dir / f"{kind.replace(' ', '_')}.{ext}")}


def _client(port, jobs):
    """One client on one connection: each job (a dict, or a raw line) in
    turn; [(reply, round trip ms)]."""
    import socket

    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=600) as sock:
        f = sock.makefile("rwb")
        for job in jobs:
            line = job if isinstance(job, str) else json.dumps(job)
            t0 = time.perf_counter()
            f.write((line + "\n").encode())
            f.flush()
            reply = json.loads(f.readline())
            out.append((reply, (time.perf_counter() - t0) * 1e3))
    return out


def _fresh_daemon(dev, tmp, root):
    """`python -m paintfe_tpu_torch.server --device cuda --port 0` (the
    type of `dev`) in a process of its own: seconds to its `serving on` line (the libraries
    loaded), then the layered .pfe job twice (the first pays the CUDA
    context), each output equal to the serial CLI's; then shutdown.
    Returns (seconds to serving, first ms, second ms)."""
    import threading

    from paintfe_tpu_torch import server as srv

    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(here), env.get("PYTHONPATH")]))
    err = open(root / "daemon.err", "w")
    t0 = time.perf_counter()
    import torch

    proc = subprocess.Popen([sys.executable, "-m", "paintfe_tpu_torch.server", "--port", "0",
                             "--device", torch.device(dev).type], cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    try:
        line = {}
        reader = threading.Thread(target=lambda: line.update(text=proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(300)
        serving_s = time.perf_counter() - t0
        if not line.get("text", "").startswith("serving on "):
            raise CheckFailed(f"server daemon: no 'serving on' line ({line.get('text')!r}); "
                              f"stderr: {(root / 'daemon.err').read_text()[-2000:]}")
        port = int(line["text"].rsplit(":", 1)[1])
        want = (tmp / SERVER_JOBS["layered pfe"][0] / SERVER_JOBS["layered pfe"][4]).read_bytes()
        ms = []
        for k in range(2):
            t1 = time.perf_counter()
            reply = srv.request(port, _server_job(tmp, "layered pfe", root / f"daemon{k}"),
                                timeout=300)
            ms.append((time.perf_counter() - t1) * 1e3)
            if not reply.get("ok") or pathlib.Path(reply["output"]).read_bytes() != want:
                raise CheckFailed(f"server daemon: job {k} {reply}, or its output differs "
                                  "from the serial CLI's")
        if not srv.request(port, {"cmd": "shutdown"}).get("shutdown") or proc.wait(30) != 0:
            raise CheckFailed(f"server daemon: shutdown failed (rc {proc.poll()})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    return serving_s, ms[0], ms[1]


def drive_server_path(dev, tmp, card):
    """The serving daemon on the card (the tenth path): serve_tcp on a daemon
    thread of this process, the jobs of SERVER_JOBS on the files the
    earlier phases wrote, each output byte-equal to that phase's serial CLI
    file: each kind once from one client (the .pfe job first: the first
    job after start; the others traced: the card's busy share), then
    SERVER_CONCURRENT from two clients at once (jobs a second against the
    same jobs from one client); a missing input and a line of bad JSON
    fail and the next job succeeds; ping's jobs_done and every launch
    count exact; shutdown within 10 s; a daemon in a process of its own.  Then
    the services on a 3840x2160 layer of a Project opened on `dev`: a
    numpy plugin behind a TrustList, an untrusted and an unresponsive one;
    BackgroundRemover with SmokeSession at 320 and 1024 against
    device="cpu"; StageTimer over a K-blur call.  Returns the launch
    counts."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from paintfe_tpu_torch import server as srv

    started = time.perf_counter()
    root = tmp / "server"
    root.mkdir()
    want = {kind: tmp / spec[0] / spec[4] for kind, spec in SERVER_JOBS.items()}
    expected = {name: 0 for name in _wrappers()}
    done = []

    def check(tag, kind, reply):
        if not reply.get("ok"):
            raise CheckFailed(f"server {tag}: the {kind} job failed: {reply}")
        if pathlib.Path(reply["output"]).read_bytes() != want[kind].read_bytes():
            raise CheckFailed(f"server {tag}: the {kind} job's output differs from the "
                              f"serial CLI's {want[kind]}")
        for name, k in SERVER_LAUNCHES[kind].items():
            expected[name] += k
        done.append(kind)

    server, port = srv.serve_tcp(port=0, device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        one = {}

        def alone(kind):
            c0 = _counts()
            ((reply, ms),) = _client(port, [_server_job(tmp, kind, root / "one")])
            check("one client", kind, reply)
            got = {n: c - c0[n] for n, c in _counts().items() if c != c0[n]}
            if got != SERVER_LAUNCHES[kind]:
                raise CheckFailed(f"server: the {kind} job launched {got}, expected "
                                  f"{SERVER_LAUNCHES[kind]}")
            one[kind] = (ms, reply["elapsed_ms"])

        # each kind once from one client: the .pfe job first (the first job
        # after start; it runs again after the failures below), then the
        # others traced (the card's busy share over warm jobs)
        alone("layered pfe")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for kind in SERVER_JOBS:
                if kind != "layered pfe":
                    alone(kind)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        busy_us, _, device_ops = _device_us(prof)
        kinds = [k for _ in range(SERVER_REPEATS) for k in SERVER_CONCURRENT]
        one_s = sum(one[k][0] for k in kinds) / 1e3
        pair = [None, None]

        def send(c):
            pair[c] = _client(port, [_server_job(tmp, k, root / f"client{c}_{i}")
                                     for i, k in enumerate(kinds)])

        clients = [threading.Thread(target=send, args=(c,)) for c in range(2)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        two_s = time.perf_counter() - t0
        if any(c.is_alive() for c in clients) or None in pair:
            raise CheckFailed("server: a client of the two did not finish")
        for replies in pair:
            for kind, (reply, _) in zip(kinds, replies):
                check("two clients", kind, reply)
        bad = _client(port, [{"input": str(root / "missing.png"), "output": str(root / "x.png")},
                             "{not json", _server_job(tmp, "layered pfe", root / "after")])
        if bad[0][0].get("ok") or bad[1][0].get("ok") or not bad[1][0]["error"].startswith(
                "bad json"):
            raise CheckFailed(f"server: a missing input or bad JSON did not fail: {bad[:2]}")
        check("after two failures", "layered pfe", bad[2][0])
        again = (bad[2][1], bad[2][0]["elapsed_ms"])
        ping = srv.request(port, {"cmd": "ping"})
        if ping.get("jobs_done") != len(done):
            raise CheckFailed(f"server: ping reports {ping}, expected jobs_done {len(done)}")
        t0 = time.perf_counter()
        if not srv.request(port, {"cmd": "shutdown"}).get("shutdown"):
            raise CheckFailed("server: shutdown was not acknowledged")
        thread.join(10)
        if thread.is_alive():
            raise CheckFailed("server: the serving thread did not stop within 10 s")
        stop_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if thread.is_alive():
            server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    counts = _counts()
    if counts != expected:
        raise CheckFailed(f"server: launches {counts}, expected {expected} for {len(done)} jobs")
    print(f"  ok  server: {len(done)} jobs, each output equal to the serial CLI's file; "
          f"launches exact {counts}; ping jobs_done {ping['jobs_done']}; a missing input and "
          f"bad JSON replied ok: false and the next job ran; shutdown in {stop_ms:.1f} ms")
    print("  server, one client, each kind once (round trip ms / the reply's elapsed_ms): "
          + ", ".join(f"{k} {ms:.1f}/{el}" for k, (ms, el) in one.items())
          + f"; the .pfe job first after start, again after the failures {again[0]:.1f}/"
          f"{again[1]}; card busy {busy_us / 1e3:.3f} ms of the {traced_ms:.1f} ms the other "
          f"five took ({busy_us / 1e1 / traced_ms:.2f}%, {device_ops} device operations) "
          f"[card: {card}]")
    print("  server, two clients at once: " + "; ".join(
        f"client {c}: " + ", ".join(f"{k} {ms:.1f}/{r['elapsed_ms']}"
                                   for k, (r, ms) in zip(kinds, pair[c])) for c in range(2))
        + f"; {2 * len(kinds) / two_s:.3f} jobs/s against {len(kinds) / one_s:.3f} with one")
    serving_s, daemon_first, daemon_second = _fresh_daemon(dev, tmp, root)
    print(f"  ok  server daemon in its own process (--device {torch.device(dev).type}): serving after "
          f"{serving_s:.3f} s (process start, import, the libraries loaded); the layered .pfe "
          f"job first {daemon_first:.1f} ms, again {daemon_second:.1f} ms (in this process: "
          f"{one['layered pfe'][0]:.1f} ms first, {again[0]:.1f} again); outputs equal the "
          "serial CLI's")
    blurs = server_services(dev, tmp, root, card)
    torch.cuda.synchronize()
    counts = _counts()
    expected["gaussian_blur_fused"] += blurs
    if counts != expected:
        raise CheckFailed(f"server path: launches {counts}, expected {expected}")
    print(f"  server phase: {time.perf_counter() - started:.1f} s wall [card: {card}]")
    return counts


def server_services(dev, tmp, root, card):
    """The plugin host, the background remover and StageTimer on a
    3840x2160 layer of the layered phase's document opened on `dev`.
    Returns the K-blur launches it made (StageTimer's)."""
    import torch

    from paintfe_tpu_torch import Project
    from paintfe_tpu_torch.ops import ai
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_fused
    from paintfe_tpu_torch.ops.plugins import PluginError, PluginHost, TrustList
    from paintfe_tpu_torch.utils.profiling import StageTimer

    proj = Project.open(tmp / "layered" / "serial" / "d0.pfe", device=dev)
    x = torch.from_numpy(proj.canvas.layers[proj.canvas.active_layer_index].pixels).to(dev)
    exe = root / "invert_plugin.py"
    exe.write_text(NUMPY_PLUGIN)
    TrustList(root / "trust.txt").trust(exe)
    trust = TrustList(root / "trust.txt")
    host = PluginHost(exe, trust=trust, launcher=(sys.executable,), timeout=120)
    try:
        host.describe()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = host.render("invert", x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        host.close()
    if out.device != x.device or not torch.equal(out, inverted(x)):
        raise CheckFailed("plugin: the render differs from 255 - x on RGB with alpha kept")
    untrusted = root / "untrusted_plugin.py"
    untrusted.write_text(NUMPY_PLUGIN + "# another build\n")
    try:
        PluginHost(untrusted, trust=trust, launcher=(sys.executable,))
        raise CheckFailed("plugin: an untrusted plugin was started")
    except PluginError:
        pass
    hang = root / "hang_plugin.py"
    hang.write_text("import time\ntime.sleep(600)\n")
    stuck = PluginHost(hang, launcher=(sys.executable,), timeout=1.0)
    t0 = time.perf_counter()
    try:
        stuck.describe()
        raise CheckFailed("plugin: an unresponsive plugin answered")
    except PluginError as e:
        killed_s = time.perf_counter() - t0
        if "unresponsive" not in str(e) or killed_s > 10:
            raise CheckFailed(f"plugin: the unresponsive plugin: {e} after {killed_s:.1f} s")
    finally:
        stuck.close()
    ms = statistics.median(times)
    mb = x.numel() / 1e6
    print(f"  ok  plugin: numpy invert of a {x.shape[1]}x{x.shape[0]} layer on the card equals "
          f"255 - x (alpha kept); round trip {ms:.1f} ms median of 3 ({mb / ms * 1e3:.1f} MB/s "
          f"of the frame, {mb:.1f} MB each way, base64 on one line); untrusted refused; "
          f"unresponsive killed after {killed_s:.2f} s [card: {card}]")

    for kind, probabilities in (("u2net", False), ("birefnet", True)):
        on_card = ai.BackgroundRemover(model_kind=kind, session=SmokeSession(probabilities),
                                       device=dev)
        on_cpu = ai.BackgroundRemover(model_kind=kind, session=SmokeSession(probabilities),
                                      device="cpu")
        for threshold in (None, 0.5):
            got = on_card.remove_background(x, threshold)
            if got.device != x.device or not torch.equal(
                    got.cpu(), on_cpu.remove_background(x.cpu(), threshold)):
                raise CheckFailed(f"ai {kind}: the card's remove_background (threshold "
                                  f"{threshold}) differs from device='cpu'")
        # the call's steps one by one: the host's on the wall clock, the
        # card's (copies included) by CUDA events, _time_ms's median
        h, w = x.shape[:2]
        host, on_dev = {}, {}
        t0 = time.perf_counter()
        rgb = ai._resize_rgb(x, on_card.size)
        host["download and resize"] = (time.perf_counter() - t0) * 1e3
        on_dev["upload and normalise"] = _time_ms(lambda: ai._normalize(rgb, x.device))
        pre = ai._normalize(rgb, x.device)
        on_dev["feed download"] = _time_ms(lambda: pre.cpu())
        feed = pre.cpu().numpy()
        t0 = time.perf_counter()
        raw = on_card.session.run(None, {on_card.input_name: feed})[0]
        t1 = time.perf_counter()
        m8 = ai._mask_u8(raw, h, w)
        host["session"], host["sigmoid, min-max and resize"] = (
            (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        on_dev["mask upload and divide"] = _time_ms(lambda: ai._unit_mask(m8, x.device))
        mask = ai._unit_mask(m8, x.device)
        on_dev["alpha"] = _time_ms(lambda: ai._apply_mask(x, mask))
        print(f"  ok  ai {kind} ({on_card.size}x{on_card.size}, "
              f"{'probabilities' if probabilities else 'logits'}): remove_background on the "
              f"card equals device='cpu' with and without a threshold; host "
              f"{sum(host.values()):.1f} ms (" + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
              + f"), card {sum(on_dev.values()):.3f} ms (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in on_dev.items()) + f") [card: {card}]")

    timer = StageTimer(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with timer.stage("blur") as h:
        start.record()
        h.result = gaussian_blur_fused(x, 8.0)
        end.record()
    event_ms, stage_ms = start.elapsed_time(end), timer.totals()["blur"] * 1e3
    if stage_ms < event_ms:
        raise CheckFailed(f"StageTimer: {stage_ms:.3f} ms, below the K-blur call's CUDA-event "
                          f"time {event_ms:.3f} ms")
    print(f"  ok  StageTimer on the card: {stage_ms:.3f} ms over a K-blur call whose CUDA "
          f"events read {event_ms:.3f} ms")
    return 1


# The multi-GPU path: one canvas at the reference's document cap
# (src/canvas/tiled_image.rs:14-26, 256 Mpix) row-split over meshes of
# MULTIGPU_ROWS entries (the card's entries repeat where the machine has
# fewer cards), a batch of 4K frames on a MULTIGPU_GRID ('batch', 'rows')
# mesh, then the multi-process CLI
MULTIGPU_CANVAS = (16384, 16384)
MULTIGPU_ROWS = (2, 4, 8)
MULTIGPU_GRID = (2, 4)
MULTIGPU_MODES = (0, 8, 16, 3, 21)
MULTIGPU_OPACITIES = (1.0, 0.8, 0.5, 0.9, 0.7)
MULTIGPU_TIMED_RUNS = 3
# rows of each full-width strip in which a single-device result is held to
# its plain version (the plain versions' f32 intermediates of the whole
# canvas would not fit the card)
MULTIGPU_PLAIN_STRIP = 2048


def _mesh_devices(n):
    """n mesh entries over this machine's cards, in turn (all cuda:0 on a
    machine with one card)."""
    import torch

    count = torch.cuda.device_count()
    return [torch.device("cuda", k % count) for k in range(n)]


def _swirl_field(h, w, dev):
    """tests/test_spatial.py's swirl, with out-of-bounds corners, built on
    the card."""
    import torch

    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    sx = (xx + 3.0 * torch.sin(yy / 9.0) - 1.5).expand(h, w).contiguous()
    sy = (yy + 2.0 * torch.cos(xx / 7.0) + 0.75).expand(h, w).contiguous()
    return sx, sy


def _spatial_chain(x, blur=None):
    """process_spatial's chain (tests/test_spatial.py): a blur at sigma 1.5
    (K-blur, or `blur`), brightness/contrast, sepia."""
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_fused
    from paintfe_tpu_torch.parallel.pipeline import _bc_device, _sepia_device

    return _sepia_device(_bc_device((blur or gaussian_blur_fused)(x, 1.5), 10.0, 20.0), 0.5)


def _clamped_rows(t, a, b, r, axis=0):
    """Rows a - r .. b + r of `t` along `axis`, indices clamped to its
    extent: rows a..b with the r rows of edge-clamped context a
    neighbourhood of radius r reads."""
    import torch

    idx = torch.arange(a - r, b + r, device=t.device).clamp_(0, t.shape[axis] - 1)
    return t.index_select(axis, idx)


def _plain_strips(plain, r):
    """plain(*inputs) on rows a..b of a whole-image function of radius r:
    a function (a, b, *inputs) -> plain's rows a..b, computed on the rows
    with their clamped context and cropped."""
    def rows(a, b, *inputs):
        out = plain(*(_clamped_rows(t, a, b, r) for t in inputs))
        return out[r:r + b - a]
    return rows


def _spatial_calls(canvas, ov, stack, sx, sy):
    """The sharded calls of the multi-GPU path, by name: (the kernel that
    each block launches, the sharded call on a mesh, the single-device
    call, the halo radius, the plain version's rows a..b)."""
    from paintfe_tpu_torch.core.composite import composite_stack_static
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import (composite_stack_plain, gaussian_blur_fused,
                                               gaussian_blur_plain, median_kernel, median_plain)
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_plain, gather_bilinear_u8
    from paintfe_tpu_torch.parallel import spatial

    def radius(sigma):
        return len(gaussian_kernel(sigma)) // 2

    r2, r3, r15 = radius(2.0), radius(3.0), radius(1.5)
    chain_rows = _plain_strips(fused_chain, r2)
    median_rows = _plain_strips(lambda x: median_plain(x, 2), 2)
    blur_rows = _plain_strips(lambda x: gaussian_blur_plain(x, 3.0), r3)
    bcs_rows = _plain_strips(lambda x: _spatial_chain(x, gaussian_blur_plain), r15)
    calls = {
        "fused_chain_spatial": (
            "fused_chain_kernel", lambda m: spatial.fused_chain_spatial(canvas, ov, m),
            lambda: fused_chain_kernel(canvas, ov), r2,
            lambda a, b: chain_rows(a, b, canvas, ov)),
        "median_spatial r=2": (
            "median_kernel", lambda m: spatial.median_spatial(canvas, 2, m),
            lambda: median_kernel(canvas, 2), 2, lambda a, b: median_rows(a, b, canvas)),
        "composite_spatial": (
            "composite_stack_kernel",
            lambda m: spatial.composite_spatial(stack, MULTIGPU_MODES, MULTIGPU_OPACITIES, m),
            lambda: composite_stack_static(stack, MULTIGPU_MODES, MULTIGPU_OPACITIES), 0,
            lambda a, b: composite_stack_plain(stack[:, a:b], MULTIGPU_MODES,
                                               MULTIGPU_OPACITIES)),
        "process_spatial K-blur sigma=3": (
            "gaussian_blur_fused",
            lambda m: spatial.process_spatial(canvas, lambda x: gaussian_blur_fused(x, 3.0), m,
                                              halo=r3),
            lambda: gaussian_blur_fused(canvas, 3.0), r3,
            lambda a, b: blur_rows(a, b, canvas)),
        "process_spatial blur-bc-sepia": (
            "gaussian_blur_fused",
            lambda m: spatial.process_spatial(canvas, _spatial_chain, m, halo=r15),
            lambda: _spatial_chain(canvas), r15, lambda a, b: bcs_rows(a, b, canvas)),
    }
    for mode in ("zero", "clamp"):
        calls[f"warp_spatial {mode}"] = (
            "gather_bilinear_u8",
            lambda m, mode=mode: spatial.warp_spatial(canvas, sx, sy, mode, m),
            lambda mode=mode: gather_bilinear_u8(canvas, sx, sy, mode), 0,
            lambda a, b, mode=mode: gather_bilinear_plain(canvas, sx[a:b], sy[a:b], mode))
    return calls


def _hold_to_plain(tag, got, plain_rows, strip=MULTIGPU_PLAIN_STRIP):
    """Hold a single-device result [H, ...] to its plain version, strip by
    full-width strip of `strip` rows (plain_rows(a, b): the plain rows
    a..b), tolerance 0; returns the strips compared."""
    import torch

    h = got.shape[0]
    for a in range(0, h, strip):
        b = min(h, a + strip)
        want = plain_rows(a, b)
        if want.shape != got[a:b].shape or not torch.equal(want, got[a:b]):
            diff = (want.int() - got[a:b].int()).abs() if want.shape == got[a:b].shape else None
            raise CheckFailed(f"multigpu: the single-device {tag} differs from its plain "
                              f"version in rows {a}..{b} (shape {tuple(want.shape)} against "
                              f"{tuple(got[a:b].shape)}, max abs err "
                              f"{None if diff is None else int(diff.max())})")
        del want
    return (h + strip - 1) // strip


def _launched(fn):
    """fn()'s result and the kernel launches it made, by wrapper name."""
    import torch

    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    after = _counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def drive_multigpu_path(dev, tmp, card):
    """The multi-GPU path (parallel/{mesh,distributed,spatial}), launch
    counts from 0 before its sharded calls and read after them:

    - one 16384x16384 canvas (268,435,456 px, made on the card from a
      seed) through fused_chain_spatial (sigma 2), median_spatial (r 2),
      warp_spatial (both modes, a swirl field with out-of-bounds corners),
      composite_spatial (five layers) and process_spatial (K-blur at
      sigma 3, and the blur, brightness/contrast, sepia chain) on rows
      meshes of 2, 4 and 8 entries; fused_chain_grid on a 2x4 grid mesh
      over four 3840x2160 frames; fused_chain_spatial and median_spatial
      at 2159x3840 (4K less one row) on 8 entries, and one call whose
      blocks are shorter than the halo (the single-device route);
    - each single-device result held to its plain version first (the
      canvas in full-width strips with their clamped context, tolerance
      0), then each sharded result byte-equal to it (computed before the
      counted window), each sharded call
      launching its kernel exactly once an entry (once an image an entry
      on the grid), the single-device route once;
    - after the counted window: each call's wall time sharded and on one
      device, the peak device memory and the halo rows copied;
    - the multi-process CLI (_multiprocess_cli);
    - the cross-process phase (_spatial_processes): every spatial call on
      one mesh of two processes, each counting its own launches.
    Returns the launch counts of the sharded calls, and those of the
    cross-process phase summed over its processes."""
    import torch

    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import median_kernel, median_plain
    from paintfe_tpu_torch.parallel import spatial

    h, w = MULTIGPU_CANVAS
    cards = torch.cuda.device_count()
    print(f"  multigpu: a {w}x{h} canvas ({h * w} px) on rows meshes of {MULTIGPU_ROWS} "
          f"entries over {cards} card(s) [card: {card}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(61)

    def noise(*shape):
        return torch.randint(0, 256, shape + (4,), generator=gen, dtype=torch.uint8, device=dev)

    canvas, ov = noise(h, w), noise(h, w)
    ov[: h // 8, :, 3] = 0  # clear-alpha rows pass the base
    stack = noise(len(MULTIGPU_MODES), h, w)
    sx, sy = _swirl_field(h, w, dev)
    calls = _spatial_calls(canvas, ov, stack, sx, sy)
    # each single-device result, the reference of the sharded calls, held
    # to its plain version over the whole canvas (tolerance 0) first
    t0 = time.perf_counter()
    refs, strips = {}, 0
    for name, (_, _, single, _, plain_rows) in calls.items():
        refs[name] = single()
        strips += _hold_to_plain(name, refs[name], plain_rows)
        torch.cuda.empty_cache()
    frames, frame_ovs = noise(4, *UHD), noise(4, *UHD)
    frame_refs = [fused_chain_kernel(frames[i], frame_ovs[i]) for i in range(4)]
    # 4K less one row, and 20 rows: blocks of 2.5 rows under K-chain's halo
    ragged, ragged_ov = (t[:UHD[0] - 1, :UHD[1]].contiguous() for t in (canvas, ov))
    tiny, tiny_ov = (t[:20, :UHD[1]].contiguous() for t in (canvas, ov))
    extra_refs = {"ragged chain": fused_chain_kernel(ragged, ragged_ov),
                  "ragged median": median_kernel(ragged, 2),
                  "tiny chain": fused_chain_kernel(tiny, tiny_ov)}
    for tag, got, want in (
            *((f"fused_chain_kernel frame {i}", frame_refs[i],
               lambda i=i: fused_chain(frames[i], frame_ovs[i])) for i in range(4)),
            ("ragged chain", extra_refs["ragged chain"], lambda: fused_chain(ragged, ragged_ov)),
            ("ragged median", extra_refs["ragged median"], lambda: median_plain(ragged, 2)),
            ("tiny chain", extra_refs["tiny chain"], lambda: fused_chain(tiny, tiny_ov))):
        strips += _hold_to_plain(tag, got, lambda a, b, want=want: want(), strip=got.shape[0])
    torch.cuda.synchronize()
    print(f"  ok  multigpu: every single-device result equals its plain version, tolerance 0: "
          f"{len(calls)} calls at {w}x{h} in full-width strips of {MULTIGPU_PLAIN_STRIP} rows "
          f"with their clamped context, four {UHD[1]}x{UHD[0]} frames, the ragged and tiny "
          f"inputs whole ({strips} comparisons, {time.perf_counter() - t0:.1f} s)")

    meshes = {n: spatial.rows_mesh(_mesh_devices(n)) for n in MULTIGPU_ROWS}
    grid = spatial.grid_mesh(*MULTIGPU_GRID, _mesh_devices(MULTIGPU_GRID[0] * MULTIGPU_GRID[1]))
    nb, nr = MULTIGPU_GRID

    def check(tag, got, want, launched, expect):
        if launched != expect:
            raise CheckFailed(f"multigpu: {tag} launched {launched}, expected {expect}")
        if got.shape != want.shape or not torch.equal(got, want):
            raise CheckFailed(f"multigpu: {tag} differs from the single-device kernel")

    # the counted window: every call at 16384 rows and at 2159 is sharded,
    # one launch a mesh entry; 20 rows take the single-device route, one
    _reset_counts()
    for name, (kernel, sharded, _, r, _) in calls.items():
        for n, mesh in meshes.items():
            out, launched = _launched(lambda: sharded(mesh))
            check(f"{name} n={n} ({spatial.route(h, n, r)})", out, refs[name], launched,
                  {kernel: n})
            del out
    out, launched = _launched(lambda: spatial.fused_chain_grid(frames, frame_ovs, grid))
    check(f"fused_chain_grid {nb}x{nr}", out, torch.stack(frame_refs), launched,
          {"fused_chain_kernel": 4 * nr})
    mesh8, r_chain = meshes[8], calls["fused_chain_spatial"][3]
    for tag, fn, kernel, launches in (
            ("ragged chain", lambda: spatial.fused_chain_spatial(ragged, ragged_ov, mesh8),
             "fused_chain_kernel", 8),
            ("ragged median", lambda: spatial.median_spatial(ragged, 2, mesh8),
             "median_kernel", 8),
            ("tiny chain", lambda: spatial.fused_chain_spatial(tiny, tiny_ov, mesh8),
             "fused_chain_kernel", 1)):
        out, launched = _launched(fn)
        check(f"{tag} n=8", out, extra_refs[tag], launched, {kernel: launches})
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  ok  multigpu: {len(calls)} calls x meshes of {MULTIGPU_ROWS} at {w}x{h}, "
          f"fused_chain_grid on {nb}x{nr} over 4 x {UHD[1]}x{UHD[0]}, two calls at "
          f"{UHD[1]}x{UHD[0] - 1} and one single-device route, each byte-equal to the "
          "single-device kernel with exact launches")

    # times, outside the counted window; the 8-entry and grid times are the
    # cross-process phase's one-process comparison
    one_process_ms = {}
    for name, (kernel, sharded, single, r, _) in calls.items():
        one = _wall_ms(single, MULTIGPU_TIMED_RUNS)
        parts = []
        for n, mesh in meshes.items():
            ms = _wall_ms(lambda: sharded(mesh), MULTIGPU_TIMED_RUNS)
            one_process_ms[name] = (ms, f"{n} entries")
            halo_rows = 2 * (n - 1) * r
            parts.append(f"n={n} {spatial.route(h, n, r)} {ms:.3f} ms ({ms / one:.2f}x), "
                         f"halo {halo_rows} rows / {halo_rows * w * 4} B")
        print(f"  {name} ({kernel}): one device {one:.3f} ms wall; " + "; ".join(parts)
              + f" [card: {card}]")
    grid_ms = _wall_ms(lambda: spatial.fused_chain_grid(frames, frame_ovs, grid),
                       MULTIGPU_TIMED_RUNS)
    one_ms = _wall_ms(lambda: [fused_chain_kernel(frames[i], frame_ovs[i]) for i in range(4)],
                      MULTIGPU_TIMED_RUNS)
    grid_halo = nb * 2 * (nr - 1) * r_chain * (4 // nb)  # frame rows, all slabs
    print(f"  fused_chain_grid {nb}x{nr}, 4 x {UHD[1]}x{UHD[0]}: {grid_ms:.3f} ms wall, "
          f"four single-device calls {one_ms:.3f} ms; halo {grid_halo} frame rows / "
          f"{grid_halo * UHD[1] * 4} B [card: {card}]")
    print(f"  multigpu peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[card: {card}]")
    one_process_ms.update({f"fused_chain_grid {layout[0]}x{layout[1]}":
                           (grid_ms, f"the {nb}x{nr} grid") for layout in SPATIAL_LAYOUTS})
    # the calls' closures (and the loops' last ones) hold the inputs too: free
    # them all before the processes start
    del calls, sharded, single, plain_rows, canvas, ov, stack, sx, sy, refs
    del frames, frame_ovs, frame_refs, extra_refs, ragged, ragged_ov, tiny, tiny_ov
    torch.cuda.empty_cache()
    _multiprocess_cli(tmp, card)
    print(f"  multigpu processes: the parent holds {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB of device memory, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    return counts, _spatial_processes(tmp, card, one_process_ms)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _processes(args, root, wiring):
    """`python args` in one process a wiring (a dict of environment
    variables, or None for none), all started together; returns [(exit
    code, stdout, stderr)] and the wall seconds until the last ended.
    Every process is ended before this returns, also one that outlives
    600 s."""
    here = pathlib.Path(__file__).resolve().parent
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(filter(None, [str(here), base.get("PYTHONPATH")]))
    for name in ("PAINTFE_COORDINATOR", "PAINTFE_NUM_PROCESSES", "PAINTFE_PROCESS_ID"):
        base.pop(name, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *args], cwd=root, env=dict(base, **(env or {})),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for env in wiring]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
        results = [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results, time.perf_counter() - t0


def _cli_processes(argv, root, wiring):
    """`python -m paintfe_tpu_torch.cli argv` in one process a wiring
    (_processes)."""
    return _processes(["-m", "paintfe_tpu_torch.cli", *argv], root, wiring)


def _wired(n):
    """The environments of n processes of one job on this machine."""
    port = _free_port()
    return [{"PAINTFE_COORDINATOR": f"localhost:{port}", "PAINTFE_NUM_PROCESSES": str(n),
             "PAINTFE_PROCESS_ID": str(k)} for k in range(n)]


def _multiprocess_cli(tmp, card):
    """The multi-process batch CLI on the headline phase's --shard inputs
    (two 3840x2160 and two 1920x1080 PNGs) and script: one process, then
    two processes on this machine wired by PAINTFE_COORDINATOR /
    PAINTFE_NUM_PROCESSES / PAINTFE_PROCESS_ID (gloo), each on its
    round-robin share; every file equal to the headline phase's --shard
    run's; then one corrupt input in process 1's share (both exit 1) and
    partial wiring (rc 1 and the message).  Each wired process reports
    (-v) the kernel launches it made, which must be K-blur once a shape
    bucket of its share: its kernels ran on the card."""
    import shutil

    from PIL import Image

    src = tmp / "headline"
    root = tmp / "multigpu"
    root.mkdir()
    argv = ["-i", str(src / "shard" / "*.png"), "-s", str(src / "fx.rhai"), "--shard",
            "-f", "png", "--device", "cuda", "-v"]

    one, one_s = _cli_processes(argv + ["--output-dir", str(root / "one")], root, [None])
    two, two_s = _cli_processes(argv + ["--output-dir", str(root / "two")], root, _wired(2))
    for tag, results in (("one process", one), ("two processes", two)):
        for rc, out, err in results:
            if rc != 0:
                raise CheckFailed(f"multigpu CLI, {tag}: rc {rc}\n{out[-2000:]}{err[-2000:]}")
    files = sorted(str(p) for p in (src / "shard").glob("*.png"))
    for k, (_, out, _) in enumerate(two):
        share = [line for line in out.splitlines() if line.startswith("[distributed] process")]
        print(f"    process {k}: {'; '.join(share)}")
        if f"[distributed] process {k} handles 2 input(s)" not in share:
            raise CheckFailed(f"multigpu CLI: process {k} did not report its share of 2")
        # the process's own launches, counted from its start: the headline
        # script launches K-blur once a shape bucket of its share
        mine = files[k::2]
        buckets = len({Image.open(f).size for f in mine})
        head = f"[distributed] process {k} kernel launches: "
        got = [json.loads(line[len(head):]) for line in share if line.startswith(head)]
        if got != [{"gaussian_blur_fused": buckets}]:
            raise CheckFailed(f"multigpu CLI: process {k} reported launches {got} for "
                              f"{len(mine)} inputs in {buckets} shape buckets, expected "
                              f"[{{'gaussian_blur_fused': {buckets}}}] on the card")
    want = sorted(p.name for p in (src / "out_shard").iterdir())
    for tag in ("one", "two"):
        got = sorted(p.name for p in (root / tag).iterdir())
        if got != want:
            raise CheckFailed(f"multigpu CLI ({tag}): files {got}, expected {want}")
        for name in want:
            if (root / tag / name).read_bytes() != (src / "out_shard" / name).read_bytes():
                raise CheckFailed(f"multigpu CLI ({tag}): {name} differs from the "
                                  "single-process --shard run's")
    print(f"  ok  multigpu CLI: two processes {two_s:.3f} s wall against one process "
          f"{one_s:.3f} s (each from process start, 2 x 4K + 2 x 1080p), every file equal "
          f"to the single-process --shard run's [card: {card}]")

    bad = root / "bad"
    bad.mkdir()
    shutil.copy(src / "shard" / "f0.png", bad / "a0.png")
    (bad / "a1.png").write_bytes(b"not a png at all")  # process 1's share
    shutil.copy(src / "shard" / "f1.png", bad / "a2.png")
    bad_argv = ["-i", str(bad / "*.png"), "--shard", "--output-dir", str(root / "bad_out"),
                "-f", "png", "--device", "cuda"]
    # the corrupt pair and a partially wired process, all started together
    partial = {"PAINTFE_COORDINATOR": f"localhost:{_free_port()}", "PAINTFE_NUM_PROCESSES": "2"}
    results, _ = _cli_processes(bad_argv, root, _wired(2) + [partial])
    corrupt = results[:2]
    if [rc for rc, *_ in corrupt] != [1, 1]:
        raise CheckFailed(f"multigpu CLI: a corrupt input in process 1's share gave exit "
                          f"codes {[rc for rc, *_ in corrupt]}, expected [1, 1]")
    rc, _, err = results[2]
    if rc != 1 or "partial multi-process wiring: missing PAINTFE_PROCESS_ID" not in err:
        raise CheckFailed(f"multigpu CLI: partial wiring gave rc {rc}: {err[-1000:]}")
    print("  ok  multigpu CLI: a corrupt input in process 1's share -> both processes exit 1; "
          "partial wiring -> rc 1, " + err.strip().splitlines()[-1])


# The cross-process phase of the multi-GPU path: SPATIAL_PROCESSES
# processes on this machine, each holding SPATIAL_ENTRIES entries of
# cuda:0 of one global rows mesh, all on the same whole inputs
SPATIAL_PROCESSES = 2
SPATIAL_ENTRIES = 4
# fused_chain_grid's ('batch', 'rows') layouts of the global mesh: a
# 'batch' row a process (halos inside a process), and every image's rows
# across the processes; over SPATIAL_FRAMES 3840x2160 frames
SPATIAL_LAYOUTS = ((SPATIAL_PROCESSES, SPATIAL_ENTRIES), (1, SPATIAL_PROCESSES * SPATIAL_ENTRIES))
SPATIAL_FRAMES = 4


def spatial_process(out_dir, dev=None, shape=MULTIGPU_CANVAS, frame=UHD,
                    runs=MULTIGPU_TIMED_RUNS):
    """One process of the cross-process phase (`chip_smoke.py
    --spatial-process DIR`, wired by PAINTFE_COORDINATOR /
    PAINTFE_NUM_PROCESSES / PAINTFE_PROCESS_ID): the same inputs as every
    other process, from one seed an input, made on the card when a call
    needs them and freed after; each spatial call on the global rows mesh
    (or a 2-D layout of it) once with its launches counted, its result
    held (in the process owning the mesh's first entry) to the
    single-device kernel on the same input, then timed.  Writes
    DIR/process{rank}.json: each call's launches, whether its result was
    right (the whole result in the owner, None elsewhere), its wall ms
    (median of `runs`, the processes started together at a barrier), the
    bytes this process sent and received over gloo, its gather's seconds
    (spatial._Gather.finish); the meshes' process indices and this
    process's peak device memory."""
    import torch
    import torch.distributed as dist

    from paintfe_tpu_torch.core.composite import composite_stack_static
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_fused, median_kernel
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8
    from paintfe_tpu_torch.parallel import distributed, spatial

    if not distributed.maybe_initialize():
        raise CheckFailed("spatial process: not wired into a job")
    me, dev = distributed.rank(), dev or torch.device("cuda", 0)
    g = distributed.global_batch_mesh([dev] * SPATIAL_ENTRIES)
    rows = spatial.rows_mesh(g)
    layouts = {f"{nb}x{nr}": spatial.grid_mesh(nb, nr, g) for nb, nr in SPATIAL_LAYOUTS}
    report = {"process": me, "rows": rows.process_indices.tolist(),
              "default": spatial.rows_mesh().process_indices.tolist(),
              "layouts": {k: m.process_indices.tolist() for k, m in layouts.items()},
              "calls": {}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # what crosses processes: gloo's point-to-point bytes, and the gather's time
    moved = {"sent": 0, "received": 0, "gather_s": 0.0}
    for op, key in (("isend", "sent"), ("irecv", "received")):
        def counted(t, *a, _fn=getattr(dist, op), _key=key, **k):
            moved[_key] += t.numel() * t.element_size()
            return _fn(t, *a, **k)
        setattr(dist, op, counted)
    finish = spatial._Gather.finish

    def timed_finish(self, outs):
        t0 = time.perf_counter()
        try:
            return finish(self, outs)
        finally:
            moved["gather_s"] += time.perf_counter() - t0
    spatial._Gather.finish = timed_finish

    def noise(seed, *size):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, 256, size + (4,), generator=gen, dtype=torch.uint8, device=dev)

    def run(name, sharded, single):
        dist.barrier()
        moved.update(sent=0, received=0, gather_s=0.0)
        out, launched = _launched(sharded)
        entry = {"launches": launched, **moved}
        if me == rows.process_indices.flat[0]:
            want = single()
            entry["right"] = (out is not None and out.shape == want.shape
                              and bool(torch.equal(out, want)))
            del want
        else:
            entry["right"] = out is None
        del out
        times = []
        for _ in range(runs):
            dist.barrier()
            t0 = time.perf_counter()
            sharded()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        entry["ms"] = statistics.median(times)
        report["calls"][name] = entry
        torch.cuda.empty_cache()

    h, w = shape
    r3 = len(gaussian_kernel(3.0)) // 2
    canvas, ov = noise(91, h, w), noise(92, h, w)
    ov[: h // 8, :, 3] = 0  # clear-alpha rows pass the base
    run("fused_chain_spatial", lambda: spatial.fused_chain_spatial(canvas, ov, rows),
        lambda: fused_chain_kernel(canvas, ov))
    tiny, tiny_ov = canvas[:20, :frame[1]].contiguous(), ov[:20, :frame[1]].contiguous()
    run("single-device route", lambda: spatial.fused_chain_spatial(tiny, tiny_ov, rows),
        lambda: fused_chain_kernel(tiny, tiny_ov))
    del ov, tiny, tiny_ov
    run("median_spatial r=2", lambda: spatial.median_spatial(canvas, 2, rows),
        lambda: median_kernel(canvas, 2))
    run("process_spatial K-blur sigma=3",
        lambda: spatial.process_spatial(canvas, lambda x: gaussian_blur_fused(x, 3.0), rows,
                                        halo=r3),
        lambda: gaussian_blur_fused(canvas, 3.0))
    sx, sy = _swirl_field(h, w, dev)
    for mode in ("zero", "clamp"):
        run(f"warp_spatial {mode}", lambda: spatial.warp_spatial(canvas, sx, sy, mode, rows),
            lambda: gather_bilinear_u8(canvas, sx, sy, mode))
    del canvas, sx, sy
    torch.cuda.empty_cache()
    stack = noise(93, len(MULTIGPU_MODES), h, w)
    run("composite_spatial",
        lambda: spatial.composite_spatial(stack, MULTIGPU_MODES, MULTIGPU_OPACITIES, rows),
        lambda: composite_stack_static(stack, MULTIGPU_MODES, MULTIGPU_OPACITIES))
    del stack
    torch.cuda.empty_cache()
    frames = noise(94, SPATIAL_FRAMES, *frame)
    frame_ovs = noise(95, SPATIAL_FRAMES, *frame)
    for layout, mesh in layouts.items():
        run(f"fused_chain_grid {layout}",
            lambda: spatial.fused_chain_grid(frames, frame_ovs, mesh),
            lambda: torch.stack([fused_chain_kernel(frames[i], frame_ovs[i])
                                 for i in range(SPATIAL_FRAMES)]))
    torch.cuda.synchronize()
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["imports_jax"] = "jax" in sys.modules or "paintfe_tpu" in sys.modules
    pathlib.Path(out_dir, f"process{me}.json").write_text(json.dumps(report))
    return 0


def _spatial_launches(name, process, rows):
    """The launches a call of the cross-process phase must make in
    `process` (`rows`: the process of each entry of the rows mesh): one
    an owned entry (an image an entry on a grid layout nb x nr: each
    entry's slab holds SPATIAL_FRAMES / nb images); on the single-device
    route one, in the process owning the first entry."""
    kernel = ("median_kernel" if name.startswith("median") else
              "gather_bilinear_u8" if name.startswith("warp") else
              "composite_stack_kernel" if name.startswith("composite") else
              "gaussian_blur_fused" if name.startswith("process_spatial") else
              "fused_chain_kernel")
    if name == "single-device route":
        return {kernel: 1} if process == rows[0] else {}
    per_image = 1
    if name.startswith("fused_chain_grid"):
        per_image = SPATIAL_FRAMES // int(name.split()[-1].split("x")[0])
    return {kernel: rows.count(process) * per_image}


def _spatial_processes(tmp, card, one_process_ms):
    """The cross-process phase: spatial_process in SPATIAL_PROCESSES
    processes; every one exits 0, every call right in every process (the
    whole result, byte-equal to the single-device kernel, in process 0;
    None elsewhere), with exact launches in each process.  Prints each
    call's wall time against `one_process_ms` (the same call in one
    process on 8 entries of the card, by name), the gather's bytes and
    seconds, each process's peak device memory and the phase's seconds.
    Returns the launches of the counted calls, summed over the
    processes, by wrapper name (as _counts)."""
    out = tmp / "spatial_processes"
    out.mkdir()
    here = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    results, wall = _processes([str(here / "chip_smoke.py"), "--spatial-process", str(out)],
                               here, _wired(SPATIAL_PROCESSES))
    for k, (rc, stdout, err) in enumerate(results):
        if rc != 0:
            raise CheckFailed(f"multigpu processes: process {k} exited {rc}\n"
                              f"{stdout[-2000:]}{err[-3000:]}")
    reports = [json.loads((out / f"process{k}.json").read_text())
               for k in range(SPATIAL_PROCESSES)]
    # the rows mesh: SPATIAL_ENTRIES entries a process in rank order, as
    # rows_mesh() with no devices spans every process's cards
    rows = [k for k in range(SPATIAL_PROCESSES) for _ in range(SPATIAL_ENTRIES)]
    for r in reports:
        default = r["default"]
        if (r["rows"] != rows or default != sorted(default)
                or set(default) != set(range(SPATIAL_PROCESSES)) or r["imports_jax"]):
            raise CheckFailed(f"multigpu processes: process {r['process']}'s meshes "
                              f"{r['rows']}, {default} or its imports (JAX: "
                              f"{r['imports_jax']}) differ from the plan")
    total = dict.fromkeys(KERNEL_SOURCES, 0)
    for name in reports[0]["calls"]:
        for k, report in enumerate(reports):
            got = report["calls"][name]
            want = _spatial_launches(name, k, rows)
            if got["launches"] != want or not got["right"]:
                raise CheckFailed(f"multigpu processes: {name} in process {k}: launched "
                                  f"{got['launches']} (expected {want}), result "
                                  f"{'right' if got['right'] else 'WRONG'}")
            for kernel, n in got["launches"].items():
                total[kernel] += n
        owner, other = reports[0]["calls"][name], reports[1]["calls"][name]
        one, on = one_process_ms.get(name, (None, None))
        against = (f"one process on {on} {one:.3f} ms ({owner['ms'] / one:.2f}x)" if one
                   else "the single-device route")
        print(f"  {name}: {SPATIAL_PROCESSES} processes {owner['ms']:.3f} ms wall "
              f"(process 0), {against}; gather {other['sent']} B sent by process 1, "
              f"{owner['received']} B received by process 0, "
              f"{other['gather_s']:.3f} / {owner['gather_s']:.3f} s in the gather "
              f"(process 1 / 0) [card: {card}]")
    print("  multigpu processes peak device memory: " + ", ".join(
        f"process {r['process']} {r['peak_gib']:.2f} GiB" for r in reports)
        + f" [card: {card}]")
    print(f"  ok  multigpu processes: {len(reports[0]['calls'])} calls on a {len(rows)}-entry "
          f"mesh of {SPATIAL_PROCESSES} processes x {SPATIAL_ENTRIES} entries, each result "
          f"byte-equal to the single-device kernel in process 0 and None in process 1, exact "
          f"launches in each ({total}); the phase {time.perf_counter() - t0:.1f} s "
          f"({wall:.1f} s the processes) [card: {card}]")
    return total


def drive_blur_pass_entry(dev, png):
    """gaussian_blur_pallas on a flattened 3840x2160 result, launch counts
    from 0 just before it: K-pass's one entry point, which no CLI path
    calls.  It must launch K-pass exactly twice (one pass each way) and no
    other kernel, and equal its plain version.  Returns the launch counts."""
    import numpy as np
    import torch
    from PIL import Image

    from paintfe_tpu_torch.ops.kernels import gaussian_blur_pallas

    flat = torch.from_numpy(np.array(Image.open(png))).to(dev)
    _reset_counts()
    blurred = gaussian_blur_pallas(flat, 2.0)
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  gaussian_blur_pallas entry call launches: {counts}")
    if counts != {name: 2 if name == "gaussian_blur_pass" else 0 for name in counts}:
        raise CheckFailed("gaussian_blur_pallas: expected two K-pass launches "
                          f"and no other kernel, got {counts}")
    if not torch.equal(blurred, _plain_blur_pallas(flat, 2.0)):
        raise CheckFailed("gaussian_blur_pallas differs from its plain version")
    print("  ok  gaussian_blur_pallas (two K-pass launches) equals its plain version")
    return counts


def _layered_document(rng, h, w):
    """A six-layer document: an opaque-left background, MULTIPLY at 0.7,
    SOFT_LIGHT (the active layer), a brightness/contrast adjustment layer
    at 0.6, SCREEN, and a DIFFERENCE layer in a hidden folder.  Raster
    content is gradients plus noise; the top-right 128x256 block is empty
    in every layer, so tiles stay empty after the script and the
    active-tile mask clears them."""
    import numpy as np

    from paintfe_tpu_torch.core.blend import BlendMode
    from paintfe_tpu_torch.core.canvas import (Canvas, Layer, LayerFolder,
                                               canonicalize_tiles)
    from paintfe_tpu_torch.core.deep import AdjustmentKind, AdjustmentLayerData

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    doc = Canvas(width=w, height=h)
    doc.folders = [LayerFolder(id=1, name="hidden", visible=False)]
    specs = [("background", BlendMode.NORMAL, 1.0), ("multiply", BlendMode.MULTIPLY, 0.7),
             ("soft", BlendMode.SOFT_LIGHT, 1.0), ("bc", None, 0.6),
             ("screen", BlendMode.SCREEN, 1.0), ("hidden", BlendMode.DIFFERENCE, 1.0)]
    for k, (name, mode, opacity) in enumerate(specs):
        layer = Layer.new(name, w, h)
        layer.opacity = opacity
        if mode is None:
            layer.content = "adjustment"
            layer.adjustment = AdjustmentLayerData(
                kind=AdjustmentKind.BRIGHTNESS_CONTRAST, brightness=10.0, contrast=20.0)
        else:
            layer.blend_mode = mode
            waves = [np.sin(xx * (0.003 + 0.001 * c + 0.0007 * k) + yy * (0.002 * c - 0.004)
                            + k) for c in range(4)]
            px = np.stack([(v + 1.0) * 110.0 for v in waves], axis=-1)
            px += rng.integers(0, 24, (h, w, 4))
            px = np.clip(px, 0, 255).astype(np.uint8)
            if k == 0:
                px[:, : w // 2, 3] = 255  # opaque left half
            px[:128, w - 256:] = 0
            layer.pixels = canonicalize_tiles(px)
        doc.layers.append(layer)
    doc.layers[5].folder_id = 1
    doc.active_layer_index = 2
    return doc


@contextlib.contextmanager
def _plain_fold():
    """Route the compositor's fold through composite_stack_plain."""
    import paintfe_tpu_torch.core.composite as composite
    from paintfe_tpu_torch.ops.kernels import composite_stack_plain

    kernel = composite.composite_stack_kernel
    composite.composite_stack_kernel = composite_stack_plain
    try:
        yield
    finally:
        composite.composite_stack_kernel = kernel


def _plain_layered(path, dev):
    """The CLI's steps on one document through the plain versions on the
    card: the script on the active layer, the canvas ops replayed on the
    others.  Returns the document before the flatten."""
    import torch

    from paintfe_tpu_torch.core.canvas import canonicalize_tiles
    from paintfe_tpu_torch.io.pfe import load_pfe
    from paintfe_tpu_torch.ops import transform as tfm
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_plain

    doc = load_pfe(str(path))
    for k, layer in enumerate(doc.layers):
        px = layer.pixels
        if k == doc.active_layer_index:
            px = gaussian_blur_plain(torch.from_numpy(px).to(dev), 2.0).cpu().numpy()
        px = tfm.flip_horizontal(tfm.rotate_180(px))
        layer.pixels = canonicalize_tiles(px) if k == doc.active_layer_index else px
    return doc


def drive_layered_path(dev, tmp):
    """The layered-document path: the serial CLI on two 3840x2160 V3
    documents (with its load / script / flatten / encode times), --shard on
    those two and a 1920x1080 one, -f pfe on one.  Checks exit codes, exact
    launch counts (two raster runs per document, one blur each) and every
    output against the plain route on the card, then composite_device and a
    preview overlay blended on the card.  Returns the launch counts of the
    path."""
    import numpy as np
    import torch
    from PIL import Image

    from paintfe_tpu_torch import cli
    from paintfe_tpu_torch.core.blend import BlendMode
    from paintfe_tpu_torch.core.canvas import active_tile_mask_device, tile_window, upload
    from paintfe_tpu_torch.core.device import DeviceLayerCache, composite_device
    from paintfe_tpu_torch.io.pfe import load_pfe, save_pfe

    root = tmp / "layered"
    for d in ("serial", "shard"):
        (root / d).mkdir(parents=True)
    (root / "fx.rhai").write_text(LAYERED)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    for name, (h, w) in (("d0", UHD), ("d1", UHD), ("f0", FHD)):
        doc = _layered_document(rng, h, w)
        save_pfe(doc, str(root / "shard" / f"{name}.pfe"))
        if name != "f0":
            save_pfe(doc, str(root / "serial" / f"{name}.pfe"))
    print(f"  layered: wrote 3 documents with save_pfe ({time.perf_counter() - t0:.3f} s)")
    argv = ["-s", str(root / "fx.rhai"), "--device", "cuda"]
    runs = [("serial", ["-i", str(root / "serial" / "*.pfe"), "-f", "png", "--profile"]),
            ("shard", ["-i", str(root / "shard" / "*.pfe"), "-f", "png", "--shard"]),
            ("pfe", ["-i", str(root / "serial" / "d0.pfe"), "-f", "pfe"])]
    # per run: documents, K-composite launches (two raster runs a document
    # flattened), K-blur launches (one apply_blur a document)
    expected = {"serial": (2, 4, 2), "shard": (3, 6, 3), "pfe": (1, 0, 1)}
    for tag, args in runs:
        c0 = _counts()
        t1 = time.perf_counter()
        rc = cli.main(args + ["--output-dir", str(root / f"out_{tag}"), *argv])
        t2 = time.perf_counter()
        c1 = _counts()
        n_docs, n_comp, n_blur = expected[tag]
        got = (c1["composite_stack_kernel"] - c0["composite_stack_kernel"],
               c1["gaussian_blur_fused"] - c0["gaussian_blur_fused"])
        print(f"  layered {tag}: rc {rc} ({t2 - t1:.3f} s, {n_docs} documents); "
              f"K-composite {got[0]}, K-blur {got[1]} launches")
        if rc != 0:
            raise CheckFailed(f"layered {tag}: CLI exit code {rc}")
        if got != (n_comp, n_blur):
            raise CheckFailed(f"layered {tag}: launched K-composite {got[0]} and "
                              f"K-blur {got[1]} times for {n_docs} documents, "
                              f"expected {n_comp} and {n_blur}")
    torch.cuda.synchronize()
    launches = _counts()
    _check_launched("layered", launches, ("composite_stack_kernel", "gaussian_blur_fused"))

    with _plain_fold():
        for tag, folder, names in (("serial", "serial", ("d0", "d1")),
                                   ("shard", "shard", ("d0", "d1", "f0"))):
            for name in names:
                want = _plain_layered(root / folder / f"{name}.pfe", dev).composite(device=dev)
                got = np.asarray(Image.open(root / f"out_{tag}" / f"{name}.png"))
                if not np.array_equal(got, want):
                    raise CheckFailed(f"layered {tag}: {name}.png differs from the "
                                      "plain route")
    # -f pfe times no stage (as the JAX CLI): the write is timed here
    want_doc = _plain_layered(root / "serial" / "d0.pfe", dev)
    t0 = time.perf_counter()
    save_pfe(want_doc, str(root / "want.pfe"))
    print(f"  layered: save_pfe of one 3840x2160 document {time.perf_counter() - t0:.3f} s")
    if (root / "out_pfe" / "d0.pfe").read_bytes() != (root / "want.pfe").read_bytes():
        raise CheckFailed("layered pfe: d0.pfe differs from the plain route's bytes")
    processed = _plain_layered(root / "serial" / "d1.pfe", dev)
    vis = processed.visible_layers()
    if processed.active_tile_mask(vis) is None:
        raise CheckFailed("layered: no 64 px tile is empty, the tile mask never ran")
    # the mask as the flatten builds it on the card, against the host definition
    resident = [upload(l.pixels, dev) for _, l in vis if l.content != "adjustment"]
    h, w = processed.height, processed.width
    # the canvas, a window across the empty block's edge, a window of full tiles
    for rect in (None, (h * 9 // 10, w * 7 // 8, h // 20, w // 10),
                 (h // 20, w // 50, h // 4, w // 4)):
        ty0, tx0, rh, rw = tile_window(h, w, rect)
        on_card = active_tile_mask_device([t[ty0:ty0 + rh, tx0:tx0 + rw, 3] for t in resident],
                                          h, w, rect).cpu().numpy()
        host = processed.active_tile_mask(vis, rect)  # None: every tile holds data
        if not (on_card.all() if host is None else np.array_equal(on_card, host)):
            raise CheckFailed(f"layered: the tile mask built on the card differs from the "
                              f"host definition (rect {rect})")
    doc = load_pfe(str(root / "serial" / "d1.pfe"))
    if not np.array_equal(composite_device(doc, DeviceLayerCache(dev)).cpu().numpy(),
                          doc.composite(device=dev)):
        raise CheckFailed("layered: composite_device differs from Canvas.composite")
    # a preview overlay on the active layer, pre-blended on the card
    small = load_pfe(str(root / "shard" / "f0.pfe"))
    h, w = small.height, small.width
    small.preview = np.zeros((h, w, 4), np.uint8)
    small.preview[h // 10: h * 2 // 3, w // 10: w * 3 // 4] = np.random.default_rng(6).integers(
        0, 256, (h * 2 // 3 - h // 10, w * 3 // 4 - w // 10, 4), np.uint8)
    small.preview_blend_mode = BlendMode.OVERWRITE
    if not np.array_equal(composite_device(small, DeviceLayerCache(dev)).cpu().numpy(),
                          small.composite(device="cpu")):
        raise CheckFailed("layered: a preview composited on the card differs from "
                          "the CPU flatten")
    print("  ok  layered: PNG (serial 2, --shard 3) and .pfe outputs equal the plain "
          "route; exact launch counts; the tile mask built on the card equals the host "
          "definition; composite_device equals Canvas.composite; a preview composited on "
          "the card equals the CPU flatten")
    profile_flatten(dev, doc)
    return launches


def _plain_resized(path):
    """DOC_RESIZE's steps on one document: both resizes on every layer (the
    active one in the script, the others replayed), tiles of the active
    layer canonicalized.  Returns the document before the flatten."""
    from paintfe_tpu_torch.core.canvas import canonicalize_tiles
    from paintfe_tpu_torch.io.pfe import load_pfe
    from paintfe_tpu_torch.ops import transform as tfm

    doc = load_pfe(str(path))
    for k, layer in enumerate(doc.layers):
        px = tfm.resize_canvas(tfm.resize(layer.pixels, 1920, 1080, "lanczos3"),
                               2000, 1200, (1, 1))
        layer.pixels = canonicalize_tiles(px) if k == doc.active_layer_index else px
    doc.width, doc.height = 2000, 1200
    return doc


def drive_resized_document(dev, tmp):
    """One serial CLI run of a six-layer 3840x2160 V3 document through
    DOC_RESIZE: the resize kinds of canvas-op replay, then the flatten on
    K-composite (two raster runs: exactly two launches, no K-blur), its PNG
    equal to the plain route's flatten on the card."""
    import numpy as np
    from PIL import Image

    from paintfe_tpu_torch import cli
    from paintfe_tpu_torch.io.pfe import save_pfe

    root = tmp / "resized"
    (root / "in").mkdir(parents=True)
    (root / "fx.rhai").write_text(DOC_RESIZE)
    save_pfe(_layered_document(np.random.default_rng(8), *UHD), str(root / "in" / "r0.pfe"))
    c0 = _counts()
    t0 = time.perf_counter()
    rc = cli.main(["-i", str(root / "in" / "r0.pfe"), "-f", "png", "--profile",
                   "--output-dir", str(root / "out"), "-s", str(root / "fx.rhai"),
                   "--device", "cuda"])
    t1 = time.perf_counter()
    c1 = _counts()
    got = (c1["composite_stack_kernel"] - c0["composite_stack_kernel"],
           c1["gaussian_blur_fused"] - c0["gaussian_blur_fused"])
    print(f"  resized document: rc {rc} ({t1 - t0:.3f} s, 3840x2160 -> 2000x1200); "
          f"K-composite {got[0]}, K-blur {got[1]} launches")
    if rc != 0:
        raise CheckFailed(f"resized document: CLI exit code {rc}")
    if got != (2, 0):
        raise CheckFailed(f"resized document: launched K-composite {got[0]} and K-blur "
                          f"{got[1]} times, expected 2 and 0")
    with _plain_fold():
        want = _plain_resized(root / "in" / "r0.pfe").composite(device=dev)
    out = np.asarray(Image.open(root / "out" / "r0.png"))
    if out.shape != (1200, 2000, 4) or not np.array_equal(out, want):
        raise CheckFailed("resized document: r0.png differs from the plain route")
    print("  ok  resized document: 2000x1200 PNG equals the plain route's flatten")


# ---------------------------------------------------------------------------
# The document-editing path: Project.open, then selections, the magic wand,
# layer and mask ops, the clipboard and canvas transforms, each pushed to the
# project's history; undo to the start and redo to the end; merge down,
# viewport, LOD, soft proof, flatten and save (tests/test_torch_document_path.py
# runs the same steps against the JAX package on the CPU)
# ---------------------------------------------------------------------------


def port_modules():
    """The port's modules of the document path, by the names document_steps
    reads (the JAX package's modules carry the same names)."""
    import types

    from paintfe_tpu_torch.core import history, mirror, project, selection
    from paintfe_tpu_torch.ops import (canvas_ops, canvas_transform, clipboard,
                                       color_removal, fill)

    return types.SimpleNamespace(
        selection=selection, history=history, mirror=mirror, project=project,
        canvas_ops=canvas_ops, canvas_transform=canvas_transform,
        clipboard=clipboard, color_removal=color_removal, fill=fill)


def _flat_box(h, w):
    """(y0, y1, x0, x1) of the flat patch that layers 1 and 2 hold, where
    the wand, the bucket fill and the flood select are seeded."""
    return h * 11 // 20, h * 17 // 20, w * 11 // 20, w * 17 // 20


def editing_document(rng, h, w, n_layers=6):
    """The first `n_layers` of a six-layer document to edit: an
    opaque-left background, MULTIPLY at 0.7 with a conceal mask, SOFT_LIGHT
    (the active layer), a brightness/contrast adjustment layer at 0.6,
    SCREEN, and a DIFFERENCE layer in a hidden folder.  Raster content is
    gradients plus noise; layers 1 and 2 hold a flat patch (_flat_box).  A
    .pfe does not keep the mask."""
    import numpy as np

    from paintfe_tpu_torch.core.blend import BlendMode
    from paintfe_tpu_torch.core.canvas import Canvas, Layer, LayerFolder
    from paintfe_tpu_torch.core.deep import AdjustmentKind, AdjustmentLayerData

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    doc = Canvas(width=w, height=h)
    doc.folders = [LayerFolder(id=1, name="hidden", visible=False)]
    specs = [("background", BlendMode.NORMAL, 1.0), ("multiply", BlendMode.MULTIPLY, 0.7),
             ("soft", BlendMode.SOFT_LIGHT, 1.0), ("bc", None, 0.6),
             ("screen", BlendMode.SCREEN, 1.0), ("hidden", BlendMode.DIFFERENCE, 1.0)]
    y0, y1, x0, x1 = _flat_box(h, w)
    # frequencies in cycles per canvas, so a small document looks like a big one
    fx, fy = 2 * np.pi / w, 2 * np.pi / h
    for k, (name, mode, opacity) in enumerate(specs[:n_layers]):
        layer = Layer.new(name, w, h)
        layer.opacity = opacity
        if mode is None:
            layer.content = "adjustment"
            layer.adjustment = AdjustmentLayerData(
                kind=AdjustmentKind.BRIGHTNESS_CONTRAST, brightness=10.0, contrast=20.0)
        else:
            layer.blend_mode = mode
            waves = [np.sin(xx * fx * (2 + c + k) + yy * fy * (3 * c - 4 + k) + k)
                     for c in range(4)]
            px = np.stack([(v + 1.0) * 110.0 for v in waves], axis=-1)
            px += rng.integers(0, 24, (h, w, 4))
            px = np.clip(px, 0, 255).astype(np.uint8)
            if k == 0:
                px[:, : w // 2, 3] = 255  # opaque left half
            if k in (1, 2):
                px[y0:y1, x0:x1] = (40 + 90 * k, 160, 90, 255)
            layer.pixels = px
        doc.layers.append(layer)
    ramp = (xx / w * 180 + yy / h * 60).astype(np.uint8)
    doc.layers[1].mask = np.where((xx + yy) % 97 < 20, 255, ramp).astype(np.uint8)
    if n_layers > 5:
        doc.layers[5].folder_id = 1
    doc.active_layer_index = 2
    return doc


def document_steps(m, kw):
    """The edits of the document path, in order, as (name, fn(project,
    clipboard)); each fn pushes its command to project.history (a
    SnapshotCommand unless a lighter command covers the edit, as the JAX
    package's tests push them).  `m` holds the modules (port_modules(), or
    the JAX package's by the same names); `kw` is passed to every call that
    does device work: {"device": dev} for the port, {} for the JAX
    package."""
    sel, co, ct = m.selection, m.canvas_ops, m.canvas_transform
    fill, cr, hist = m.fill, m.color_removal, m.history
    mode = sel.SelectionMode

    def snapshot(name, edit):
        def step(p, clip):
            cmd = hist.SnapshotCommand(name, p.canvas)
            edit(p.canvas, clip)
            cmd.finalize(p.canvas)
            p.history.push(cmd)
        return name, step

    def select(name, fn):
        return snapshot(name, lambda c, clip: setattr(c, "selection", fn(c)))

    def seed(c, dy=3, dx=3):
        y0, _, x0, _ = _flat_box(c.height, c.width)
        return x0 + dx, y0 + dy

    def combine(c, new, how):
        return sel.combine(c.selection, new, how, c.width, c.height)

    def bucket(p, clip):
        layer = p.canvas.layers[1]
        before = layer.pixels
        after = fill.bucket_fill(before, *seed(p.canvas), (250, 30, 200, 255), 20.0, **kw)
        layer.pixels = after
        p.history.push(hist.PixelPatch("bucket fill", 1, before, after))

    def add_layer(name, make):
        def step(p, clip):
            prev = p.canvas.active_layer_index
            idx = make(p.canvas, clip)
            p.history.push(hist.LayerOpCommand(name, "add", idx, p.canvas.layers[idx],
                                               prev, idx))
        return name, step

    def color_to_alpha(p, clip):
        layer = p.canvas.layers[0]
        before = layer.pixels
        after = cr.color_to_alpha(before, cr.ColorToAlphaSettings(
            target=(110, 110, 110), tolerance=40.0, softness=60.0))
        layer.pixels = after
        p.history.push(hist.SingleLayerSnapshotCommand("color to alpha", 0, before, after))

    def crop(c, clip):
        w, h = c.width, c.height
        c.selection = sel.rect_mask(w, h, w // 8, h // 6, w * 7 // 8, h * 5 // 6)
        ct.crop_to_selection(c)

    return [
        select("ellipse", lambda c: combine(c, sel.ellipse_mask(
            c.width, c.height, c.width * 0.45, c.height * 0.5, c.width * 0.3,
            c.height * 0.35), mode.REPLACE)),
        select("rect add", lambda c: combine(c, sel.rect_mask(
            c.width, c.height, c.width // 10, c.height // 10, c.width // 3,
            c.height // 2), mode.ADD)),
        select("feather", lambda c: sel.feather(c.selection, 3.0)),
        select("expand", lambda c: sel.expand(c.selection, 2)),
        select("contract", lambda c: sel.contract(c.selection, 3)),
        select("color range", lambda c: sel.select_color_range(
            c.layers[2].pixels, 120.0, 40.0, 0.1, 0.5, base=c.selection, mode=mode.ADD)),
        select("magic wand", lambda c: combine(c, fill.magic_wand_mask(
            c.layers[2].pixels, *seed(c), 12.0, True, True, True, "perceptual", **kw),
            mode.ADD)),
        ("bucket fill", bucket),
        snapshot("mask from selection", lambda c, clip: co.add_layer_mask_from_selection(c, 2)),
        snapshot("invert mask", lambda c, clip: co.invert_layer_mask(c, 2)),
        add_layer("duplicate layer", lambda c, clip: co.duplicate_layer(c, 2)),
        snapshot("merge down as mask", lambda c, clip: co.merge_down_as_mask(c, 3)),
        ("copy", lambda p, clip: clip.copy(p.canvas)),
        snapshot("cut", lambda c, clip: clip.cut(c, 1)),
        add_layer("paste as layer", lambda c, clip: clip.paste_as_layer(c)),
        ("color to alpha", color_to_alpha),
        select("flood select", lambda c: cr.flood_select(
            c.layers[2].pixels, *seed(c, 5, 5), 15.0, **kw)),
        snapshot("flip selected", lambda c, clip: ct.flip_canvas_horizontal(c)),
        select("select none", lambda c: None),
        snapshot("rotate 90 cw", lambda c, clip: ct.rotate_canvas_90cw(c)),
        snapshot("rotate 17.5 bilinear",
                 lambda c, clip: ct.rotate_canvas_arbitrary(c, 17.5, "bilinear", **kw)),
        snapshot("rotate -30 nearest",
                 lambda c, clip: ct.rotate_canvas_arbitrary(c, -30.0, "nearest", **kw)),
        snapshot("merge down", lambda c, clip: co.merge_down(c, 3, **kw)),
        snapshot("crop", crop),
    ]


# wall seconds of each section of the smoke (_section), printed at its end
SECTION_S = {}


@contextlib.contextmanager
def _section(name):
    t0 = time.perf_counter()
    yield
    SECTION_S[name] = time.perf_counter() - t0


def document_differences(a, b):
    """What differs between two documents of the port (an empty list when
    they are the same): dims, active layer, selection, folders, and each
    layer's state, pixels and mask."""
    import numpy as np

    def arr(x):
        return None if x is None else np.asarray(x)

    def same(x, y):
        x, y = arr(x), arr(y)
        return (x is None) == (y is None) and (
            x is None or (x.shape == y.shape and np.array_equal(x, y)))

    out = []
    for field in ("width", "height", "active_layer_index"):
        if getattr(a, field) != getattr(b, field):
            out.append(f"{field} {getattr(a, field)} != {getattr(b, field)}")
    if not same(a.selection, b.selection):
        out.append("selection")
    if [(f.id, f.name, f.visible) for f in a.folders] != \
            [(f.id, f.name, f.visible) for f in b.folders]:
        out.append("folders")
    if len(a.layers) != len(b.layers):
        return out + [f"{len(a.layers)} layers != {len(b.layers)}"]
    for k, (x, y) in enumerate(zip(a.layers, b.layers)):
        for field in ("name", "visible", "opacity", "mask_enabled", "folder_id", "content"):
            if getattr(x, field) != getattr(y, field):
                out.append(f"layer {k} {field}")
        if int(x.blend_mode) != int(y.blend_mode):
            out.append(f"layer {k} blend_mode")
        if not same(x.pixels, y.pixels):
            out.append(f"layer {k} pixels")
        if not same(x.mask, y.mask):
            out.append(f"layer {k} mask")
    return out


def _raster_runs(doc):
    """K-composite launches of one flatten of `doc`: one a run of visible
    raster layers between adjustment layers (up to 32 layers a launch)."""
    runs, n = 0, 0
    for _, layer in doc.visible_layers():
        if layer.content == "adjustment" and layer.adjustment is not None:
            runs += -(-n // 32)
            n = 0
        else:
            n += 1
    return runs + -(-n // 32)


def _timed_stage(fn, busy_ms, tag=None, device_ops=None):
    """fn's result and its wall ms, ending in a device synchronise; with a
    tag, the device's busy ms in that window (a torch.profiler trace of the
    card) go to busy_ms[tag], and the number of kernels, copies and fills
    the trace holds to device_ops[tag] where device_ops is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with (profile(activities=[ProfilerActivity.CUDA]) if tag
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    if tag:
        busy, _, ops = _device_us(prof)
        busy_ms[tag] = busy / 1e3
        if device_ops is not None:
            device_ops[tag] = ops
    return out, ms


def drive_document_path(dev, tmp, card):
    """The document-editing path at 3840x2160 on a six-layer document
    (editing_document; a .pfe keeps no masks, so the path makes its own
    from the selection and rotates it): Project.open of a .pfe, the
    edits of document_steps on the card, each pushed to the project's
    history, with launch counts from 0; the same edits on a second copy
    through the plain versions on the card (_plain_kernels, _plain_fold),
    every layer and mask held equal after each step; undo to the start
    (equal to the opened document) and redo to the end; then
    composite_viewport, composite_lod, soft_proof_cmyk of the composite,
    flatten, Project.save to .pfe and .png and a reopen of the .pfe, each
    equal to the plain route's.  K-warp must launch once (the bilinear
    rotation: every layer and mask in one batch) and K-composite once for
    merge_down and once a raster run for each flatten; no other kernel.
    Prints each stage's wall time.  Returns the launch counts of the path."""
    import numpy as np
    import torch
    from PIL import Image

    from paintfe_tpu_torch.core.history import HistoryManager
    from paintfe_tpu_torch.core.mirror import soft_proof_cmyk
    from paintfe_tpu_torch.core.project import Project
    from paintfe_tpu_torch.io.pfe import load_pfe, save_pfe
    from paintfe_tpu_torch.ops import canvas_ops, canvas_transform
    from paintfe_tpu_torch.ops.clipboard import Clipboard

    root = tmp / "document"
    root.mkdir(parents=True)
    src = root / "doc.pfe"
    save_pfe(editing_document(np.random.default_rng(9), *UHD), str(src))

    busy_ms = {}

    def timed(fn, tag=None):
        return _timed_stage(fn, busy_ms, tag)

    def check(what, a, b):
        diff = document_differences(a, b)
        if diff:
            raise CheckFailed(f"document path, {what}: the card's document differs from "
                              f"the plain route's: {diff}")

    # the plain route's project keeps no history (max_entries=0)
    plain = Project.open(src, device=dev)
    plain.history = HistoryManager(max_entries=0)
    _reset_counts()
    proj, open_ms = timed(lambda: Project.open(src, device=dev))
    proj.history = HistoryManager(max_entries=50, memory_limit_bytes=64 << 30)
    check("open", proj.canvas, plain.canvas)
    clip, plain_clip = Clipboard(), Clipboard()
    stage_ms = {"open": open_ms}
    steps = document_steps(port_modules(), {"device": dev})
    for name, step in steps:
        _, ms = timed(lambda: step(proj, clip), name)
        with _plain_kernels(), _plain_fold():
            step(plain, plain_clip)
        check(name, proj.canvas, plain.canvas)
        stage_ms[name] = ms
    torch.cuda.synchronize()
    edited = _counts()
    pushed = len(proj.history.undo_stack)
    if pushed != len(steps) - 1:  # every step but the copy pushes one command
        raise CheckFailed(f"document path: {pushed} commands in the history after "
                          f"{len(steps)} steps")
    undos, undo_ms = timed(lambda: sum(1 for _ in iter(
        lambda: proj.history.undo(proj.canvas), False)))
    check("undo to the start", proj.canvas, load_pfe(str(src)))
    redos, redo_ms = timed(lambda: sum(1 for _ in iter(
        lambda: proj.history.redo(proj.canvas), False)))
    check("redo to the end", proj.canvas, plain.canvas)
    if undos != pushed or redos != pushed:
        raise CheckFailed(f"document path: {undos} undos and {redos} redos of {pushed}")
    stage_ms.update({"undo to the start": undo_ms, "redo to the end": redo_ms})
    print(f"  document: {len(steps)} edits, {pushed} commands in the history "
          f"({proj.history.memory_bytes() / 2**30:.2f} GiB), undone and redone; every "
          "layer and mask equals the plain route's after each")

    c = proj.canvas
    runs = _raster_runs(c)
    h, w = c.height, c.width
    rect = (w // 5, h // 7, w * 3 // 4, h * 2 // 3)
    outputs = {}
    for tag, doc, ctx in (("card", c, contextlib.nullcontext), ("plain", plain.canvas,
                                                                 _plain_fold)):
        with ctx():
            on_card = tag == "card"
            view, view_ms = timed(lambda: canvas_transform.composite_viewport(
                doc, rect, device=dev), on_card and "composite_viewport")
            lod, lod_ms = timed(lambda: canvas_transform.composite_lod(doc, device=dev),
                                on_card and "composite_lod")
            proof, proof_ms = timed(lambda: soft_proof_cmyk(doc.composite(device=dev)),
                                    on_card and "soft proof (its flatten included)")
        outputs[tag] = (view, lod, proof)
        if tag == "card":
            stage_ms.update({"composite_viewport": view_ms, "composite_lod": lod_ms,
                             "soft proof (its flatten included)": proof_ms})
    for name, got, want in zip(("viewport", "LOD", "soft proof"), outputs["card"],
                               outputs["plain"]):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise CheckFailed(f"document path: the {name} differs from the plain route's")
    _, stage_ms["flatten"] = timed(lambda: canvas_ops.flatten(c, device=dev), "flatten")
    with _plain_fold():
        canvas_ops.flatten(plain.canvas, device=dev)
    check("flatten", c, plain.canvas)
    _, stage_ms["save .pfe"] = timed(lambda: proj.save(root / "out.pfe"))
    _, stage_ms["save .png"] = timed(lambda: proj.save(root / "out.png"), "save .png")
    plain.save(root / "plain.pfe")
    with _plain_fold():
        plain.save(root / "plain.png")
    torch.cuda.synchronize()
    counts = _counts()
    for a, b in (("out.pfe", "plain.pfe"), ("out.png", "plain.png")):
        if (root / a).read_bytes() != (root / b).read_bytes():
            raise CheckFailed(f"document path: {a} differs from the plain route's {b}")
    reopened, stage_ms["reopen .pfe"] = timed(lambda: Project.open(root / "out.pfe",
                                                                   device=dev))
    check("reopen", reopened.canvas, plain.canvas)
    with _plain_fold():
        flat = plain.canvas.composite(device=dev)
    if not np.array_equal(np.asarray(Image.open(root / "out.png")), flat):
        raise CheckFailed("document path: out.png differs from the plain route's "
                          "composite of the flattened document")
    print(f"  ok  document: viewport {outputs['card'][0].shape[:2]}, LOD "
          f"{outputs['card'][1].shape[:2]}, soft proof, flatten, out.pfe and out.png "
          "equal the plain route's; the reopened .pfe equals the flattened document")

    # K-composite: merge_down once, one launch a raster run for each of the
    # viewport's, the LOD's, the soft proof's and the flatten's composite,
    # and once for the .png save's flatten of the one remaining layer
    want = {name: 0 for name in counts}
    want["gather_bilinear_u8"] = 1
    want["composite_stack_kernel"] = 1 + 4 * runs + 1
    print(f"  document launches: edits {edited}, the whole path {counts} "
          f"(expected {want}: {runs} raster runs a flatten of the edited document)")
    if counts != want:
        raise CheckFailed(f"document path: launches {counts}, expected {want}")
    print(f"  document stages at {UHD[1]}x{UHD[0]}, wall ms (device busy ms, from a "
          f"torch.profiler trace of the stage, where the stage touches the card) "
          f"[card: {card}]:")
    for name, ms in stage_ms.items():
        busy = f" (device busy {busy_ms[name]:.3f})" if name in busy_ms else ""
        print(f"    {name}: {ms:.1f}{busy}")
    wall = sum(stage_ms[name] for name in busy_ms)
    print(f"  document: the card was busy {sum(busy_ms.values()):.1f} ms of the "
          f"{wall:.1f} ms those stages took ({sum(busy_ms.values()) / wall * 100:.2f}%), "
          f"{sum(stage_ms.values()) / 1e3:.1f} s of stages in all [card: {card}]")
    return counts


# ---------------------------------------------------------------------------
# The menu-edit path: the Adjustments and Effects menus, the gradient tool,
# Liquify and the mesh warp on the active layer of a document, each edit
# one history command (tests/test_torch_menu_path.py runs the same steps
# against the JAX package on the CPU)
# ---------------------------------------------------------------------------

MENU_CURVES = [([(0, 0), (64, 80), (190, 170), (255, 255)], True),
               ([(0, 10), (255, 245)], True), ([(0, 0), (128, 150), (255, 255)], True),
               ([], False), ([(0, 30), (255, 255)], True)]
MENU_STOPS = [(0.0, (20, 10, 90, 255)), (0.4, (220, 80, 30, 255)),
              (1.0, (250, 245, 200, 255))]
# the selection: an ellipse (centre and radii in canvas widths and heights)
# that reaches the left edge, so the canvas border edits the layer too
MENU_ELLIPSE = (0.4, 0.5, 0.42, 0.45)
MENU_BANDS = ((20, -30, 0, 45, -10, 5), (10, 0, -40, 20, 30, -15), (5, -5, 10, 0, -20, 15))
# dents and contours, whose host turbulence fields the path times apart
MENU_DENTS = (24.0, 0.6, 7, 2, 0.5, True, False)
MENU_CONTOURS = (40.0, 6.0, 1.5, (0, 0, 0, 255), 9, 2, 0.6)
# the menu ops in the path's order: (step name, module, function, its
# arguments after the image, or a function of the luts module giving them);
# each runs on the active layer under the selection.  "histogram" is a read.
MENU_OPS = [
    ("brightness contrast", "adjustments", "brightness_contrast", (10.0, 15.0)),
    ("hue saturation lightness", "adjustments", "hue_saturation_lightness",
     (30.0, 20.0, -10.0)),
    ("hue saturation per band", "adjustments", "hue_saturation_per_band",
     (10.0, 5.0, -5.0) + MENU_BANDS),
    ("vibrance", "adjustments", "vibrance", (45.0,)),
    ("color balance", "adjustments", "color_balance",
     ((10.0, -5.0, 20.0), (0.0, 15.0, -10.0), (-20.0, 5.0, 30.0))),
    ("temperature tint", "adjustments", "temperature_tint", (25.0, -12.0)),
    ("exposure", "adjustments", "exposure", (0.4,)),
    ("highlights shadows", "adjustments", "highlights_shadows", (40.0, -30.0)),
    ("curves", "adjustments", "curves", (MENU_CURVES,)),
    ("curves direct", "adjustments", "curves_direct", (MENU_CURVES[::-1],)),
    ("rgb lut", "adjustments", "apply_rgb_lut", lambda luts: (luts.compose_luts(
        luts.curves_lut(MENU_CURVES[0][0]), luts.stretch_lut(12, 240)),)),
    ("rgba luts", "adjustments", "apply_rgba_luts", lambda luts: (
        luts.multi_channel_luts(MENU_CURVES[1:] + MENU_CURVES[:1]),)),
    ("levels", "adjustments", "levels", (10, 240, 1.3, 5, 250)),
    ("levels direct", "adjustments", "levels_direct", (5, 250, 0.8, 0, 255)),
    ("levels per channel", "adjustments", "levels_per_channel",
     ((5, 250, 1.1, 0, 255), (0, 240, 0.9, 10, 250), (20, 255, 1.2, 0, 255),
      (0, 255, 1.0, 30, 220))),
    ("auto levels", "adjustments", "auto_levels", ()),
    ("histogram", "adjustments", "histogram", ()),
    ("invert colors", "adjustments", "invert_colors", ()),
    ("posterize", "adjustments", "posterize", (6,)),
    ("black and white", "adjustments", "black_and_white", (40.0, 40.0, 20.0)),
    ("gradient map", "adjustments", "gradient_map",
     lambda luts: (luts.gradient_map_lut(MENU_STOPS),)),
    ("gradient map stops", "adjustments", "gradient_map_stops",
     ([(0.1, (0, 60, 200, 255)), (0.9, (255, 230, 40, 255))],)),
    ("desaturate", "adjustments", "desaturate", ()),
    ("sepia", "adjustments", "sepia", ()),
    ("desaturate bt601", "adjustments", "desaturate_bt601", ()),
    ("threshold", "adjustments", "threshold", (110.0,)),
    ("invert alpha", "adjustments", "invert_alpha", ()),
    ("bokeh", "filters", "bokeh_blur", (6.0,)),
    ("zoom", "filters", "zoom_blur", (0.45, 0.5, 0.3, 8, (1.0, 0.5, 0.2, 1.0), 0.3)),
    ("dents", "distort", "dents", MENU_DENTS),
    ("grid", "render", "grid", (64, 48, 2, (255, 255, 255, 255), 0, 0.5)),
    ("canvas border", "render", "canvas_border", (12, (20, 20, 20, 255))),
    ("drop shadow", "render", "drop_shadow", (12, 9, 6.0, True, (0, 0, 0, 200), 0.8)),
    ("pixel drag", "glitch", "pixel_drag", (42, 40.0, 30, 20.0)),
    ("rgb displace", "glitch", "rgb_displace", ((4, 0), (0, -3), (-5, 2))),
    ("contours", "contours", "contours", MENU_CONTOURS),
    ("color filter", "artistic", "color_filter", ((255, 128, 0, 255), 0.5, 3)),
]
# K-warp launches of the menu path (dents, the Liquify warp, the mesh warp)
# and K-blur's (the drop shadow's alpha)
MENU_WARPS = 3
MENU_BLURS = 1
# the Liquify strokes: (step name, brush, centre in canvas widths and
# heights, deltas and radius in canvas widths, the brush's other arguments)
MENU_STROKES = [
    ("liquify push", "apply_push", (0.3, 0.4), (0.02, 0.01, 0.06), (0.8,)),
    ("liquify expand", "apply_expand", (0.6, 0.5), (0.05,), (0.7,)),
    ("liquify contract", "apply_contract", (0.45, 0.7), (0.05,), (0.9,)),
    ("liquify twirl", "apply_twirl", (0.7, 0.3), (0.06,), (1.2, True)),
]
# the steps that push no command: a read and the strokes of the field
MENU_READS = ("histogram",) + tuple(name for name, *_ in MENU_STROKES)


def _menu_stroke(field, stroke, w, h):
    """One of MENU_STROKES on a DisplacementField of a w x h canvas."""
    _, brush, (fx, fy), sizes, rest = stroke
    getattr(field, brush)(fx * w, fy * h, *[v * w for v in sizes], *rest)


def _menu_mesh(transform, w, h):
    """The mesh warp's control points on a w x h canvas: a uniform 4x3 grid
    and the same grid with each point moved by up to w / 40 (seeded)."""
    import numpy as np

    orig = transform.uniform_grid(4, 3, w, h)
    shift = np.random.default_rng(5).uniform(-1.0, 1.0, orig.shape).astype(np.float32)
    return orig, (orig + shift * np.float32(w / 40)).astype(np.float32)


def _menu_gradients(gradient, w, h):
    """The gradient steps' arguments of render_gradient after (w, h): a
    linear two-colour gradient, and a radial eraser of stops (its base is
    the layer)."""
    shape = gradient.GradientShape
    return {
        "linear gradient": dict(start=(w * 0.1, h * 0.2), end=(w * 0.8, h * 0.9),
                                color_a=(250, 200, 20, 255), color_b=(20, 60, 230, 200),
                                shape=shape.LINEAR),
        "radial eraser gradient": dict(
            start=(w * 0.5, h * 0.45), end=(w * 0.8, h * 0.6), shape=shape.RADIAL,
            eraser=True, stops=[(0.0, (255, 255, 255, 255)), (0.6, (128, 128, 128, 160)),
                                (1.0, (0, 0, 0, 0))]),
    }


def menu_modules():
    """The port's modules of the menu path, by the names menu_steps reads
    (the JAX package's modules carry the same names)."""
    import types

    from paintfe_tpu_torch.core import history, selection
    from paintfe_tpu_torch.ops import adjustments, canvas_ops, filters, gradient, luts
    from paintfe_tpu_torch.ops import transform
    from paintfe_tpu_torch.ops.effects import artistic, contours, distort, glitch, render

    return types.SimpleNamespace(
        selection=selection, history=history, adjustments=adjustments, luts=luts,
        canvas_ops=canvas_ops, filters=filters, gradient=gradient, transform=transform,
        artistic=artistic, contours=contours, distort=distort, glitch=glitch,
        render=render)


def _host(x):
    """An op's result as a host numpy array (a torch tensor on any device,
    or a JAX array)."""
    import numpy as np

    if hasattr(x, "is_cuda"):
        x = x.cpu()
    return np.asarray(x)


def menu_steps(m, kw):
    """The edits of the menu path, in order, as (name, fn(project, state));
    `state` is a dict a run keeps (the Liquify field, the histogram).  Each
    adjustment and effect runs on the active layer under the selection and
    pushes one SingleLayerSnapshotCommand (the reference's "filter apply");
    the histogram is a read; the Liquify strokes change only the field,
    which the Liquify warp applies.  `m` holds the modules (menu_modules(),
    or the JAX package's by the same names); `kw` is passed to every call
    that does device work: {"device": dev} for the port, {} for the JAX
    package."""
    import numpy as np

    adj, luts, hist = m.adjustments, m.luts, m.history

    def layer_op(name, fn):
        """fn(pixels, selection, canvas, state) -> the active layer's new pixels"""
        def step(p, state):
            c = p.canvas
            idx = c.active_layer_index
            before = c.layers[idx].pixels
            after = np.ascontiguousarray(_host(fn(before, c.selection, c, state)), np.uint8)
            c.layers[idx].pixels = after
            p.history.push(hist.SingleLayerSnapshotCommand(name, idx, before, after))
        return name, step

    def menu(name, op, *args):
        """An op of the Adjustments or Effects menu under the selection"""
        return layer_op(name, lambda px, sel, *_: op(px, *args, mask=sel, **kw))

    def read_histogram(p, state):
        c = p.canvas
        state["histogram"] = _host(adj.histogram(c.layers[c.active_layer_index].pixels,
                                                 mask=c.selection, **kw))

    def select_ellipse(p, state):
        c = p.canvas
        cmd = hist.SnapshotCommand("ellipse", c)
        cx, cy, rx, ry = MENU_ELLIPSE
        c.selection = m.selection.ellipse_mask(c.width, c.height, c.width * cx,
                                               c.height * cy, c.width * rx, c.height * ry)
        cmd.finalize(c)
        p.history.push(cmd)

    def stroke(spec):
        """A Liquify stroke of the run's field"""
        def step(p, state):
            c = p.canvas
            if "field" not in state:
                state["field"] = m.transform.DisplacementField(c.width, c.height)
            _menu_stroke(state["field"], spec, c.width, c.height)
        return spec[0], step

    def mesh(px, sel, c, state):
        orig, deformed = _menu_mesh(m.transform, c.width, c.height)
        return m.transform.warp_mesh_catmull_rom(px, orig, deformed, 4, 3, **kw)

    def new_layer(p, state):
        c = p.canvas
        prev = c.active_layer_index
        idx = m.canvas_ops.add_layer(c, "gradient")
        p.history.push(hist.LayerOpCommand("new layer", "add", idx, c.layers[idx], prev, idx))

    def gradient(name):
        def fn(px, sel, c, state):
            spec = _menu_gradients(m.gradient, c.width, c.height)[name]
            base = {"base": px} if spec.get("eraser") else {}
            return m.gradient.render_gradient(c.width, c.height, **spec, **base, **kw)
        return layer_op(name, fn)

    steps = [("ellipse", select_ellipse)]
    for name, module, op, args in MENU_OPS:
        if name == "histogram":
            steps.append(("histogram", read_histogram))
            continue
        fn = getattr(getattr(m, module), op)
        steps.append(menu(name, fn, *(args(m.luts) if callable(args) else args)))
    return steps + [stroke(spec) for spec in MENU_STROKES] + [
        layer_op("liquify warp", lambda px, sel, c, state: m.transform.warp_displacement(
            px, state["field"], **kw)),
        layer_op("mesh warp", mesh),
        ("new layer", new_layer),
        gradient("linear gradient"),
        gradient("radial eraser gradient"),
    ]


def menu_extra_ops(h, w):
    """The menu path's ops beyond MENU_OPS, as (name, fn(img, mask)) on u8
    [H, W, 4] tensors: the Liquify warp of four strokes' field, the mesh
    warp of a displaced 4x3 grid, and the two gradients."""
    from paintfe_tpu_torch.ops import gradient, transform

    field = transform.DisplacementField(w, h)
    for spec in MENU_STROKES:
        _menu_stroke(field, spec, w, h)
    orig, deformed = _menu_mesh(transform, w, h)
    specs = _menu_gradients(gradient, w, h)
    linear, radial = specs["linear gradient"], specs["radial eraser gradient"]
    return [
        ("liquify warp", lambda x, m: transform.warp_displacement(x, field)),
        ("mesh warp", lambda x, m: transform.warp_mesh_catmull_rom(x, orig, deformed, 4, 3)),
        ("linear gradient", lambda x, m: gradient.render_gradient(w, h, **linear,
                                                                  device=x.device)),
        ("radial eraser gradient", lambda x, m: gradient.render_gradient(w, h, **radial,
                                                                         base=x)),
    ]


def menu_op_table(h, w):
    """Every op of the menu path as (name, fn(img, mask)) on u8 [H, W, 4]
    tensors (run where the tensor is)."""
    m = menu_modules()
    table = []
    for name, module, op, args in MENU_OPS:
        fn = getattr(getattr(m, module), op)
        args = args(m.luts) if callable(args) else args
        table.append((name, lambda x, mask, fn=fn, args=args: fn(x, *args, mask=mask)))
    return table + menu_extra_ops(h, w)


def _ellipse(h, w):
    """The menu path's selection: u8 [H, W], 255 inside the ellipse."""
    from paintfe_tpu_torch.core.selection import ellipse_mask

    cx, cy, rx, ry = MENU_ELLIPSE
    return ellipse_mask(w, h, w * cx, h * cy, w * rx, h * ry)


def drive_menu_path(dev, tmp, card):
    """The menu-edit path at 3840x2160 on a six-layer document
    (editing_document): Project.open of a .pfe, an elliptic selection, then
    each op of menu_steps on the card (the 27 adjustment functions, with
    the histogram a read, the effects, four Liquify strokes and the field's
    warp, a mesh warp, and a linear and a radial eraser gradient on a new
    layer), each pushed to the project's history; the same steps on a
    second copy through the plain versions on the card (_plain_kernels,
    _plain_fold), every layer and the histogram held equal after each
    step; undo to the start (equal to the opened document) and redo to the
    end; flatten and Project.save to .pfe and .png, equal to the plain
    route's.  Exact launches: K-warp MENU_WARPS (dents, the Liquify warp,
    the mesh warp), K-blur MENU_BLURS (the drop shadow), K-composite one a
    raster run of the flatten and one for the .png save; no other kernel.
    Prints the time to build the host turbulence fields, each step's wall
    ms and the card's busy ms.  Returns the launch counts of the path."""
    import numpy as np
    import torch

    from paintfe_tpu_torch.core.history import HistoryManager
    from paintfe_tpu_torch.core.project import Project
    from paintfe_tpu_torch.io.pfe import load_pfe, save_pfe
    from paintfe_tpu_torch.ops import canvas_ops
    from paintfe_tpu_torch.ops.effects.contours import contours_noise
    from paintfe_tpu_torch.ops.effects.distort import dents_noise

    h, w = UHD
    root = tmp / "menu"
    root.mkdir(parents=True)
    src = root / "doc.pfe"
    save_pfe(editing_document(np.random.default_rng(11), h, w), str(src))

    # the host turbulence fields, built once a parameter set (cached for the path)
    dents_noise.cache_clear()
    contours_noise.cache_clear()
    t0 = time.perf_counter()
    dents_noise(MENU_DENTS[0], MENU_DENTS[2], MENU_DENTS[3], MENU_DENTS[4], h, w)
    dents_field_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    contours_noise(MENU_CONTOURS[0], MENU_CONTOURS[4], MENU_CONTOURS[5], h, w)
    contours_field_ms = (time.perf_counter() - t0) * 1e3
    print(f"  menu: host turbulence fields at {w}x{h}: dents (two planes) "
          f"{dents_field_ms:.1f} ms, contours {contours_field_ms:.1f} ms")

    busy_ms = {}

    def timed(fn, tag=None):
        return _timed_stage(fn, busy_ms, tag)

    def check(what, a, b):
        diff = document_differences(a, b)
        if diff:
            raise CheckFailed(f"menu path, {what}: the card's document differs from the "
                              f"plain route's: {diff}")

    plain = Project.open(src, device=dev)
    plain.history = HistoryManager(max_entries=0)
    _reset_counts()
    proj, open_ms = timed(lambda: Project.open(src, device=dev))
    proj.history = HistoryManager(max_entries=100, memory_limit_bytes=64 << 30)
    check("open", proj.canvas, plain.canvas)
    state, plain_state = {}, {}
    stage_ms = {"open": open_ms}
    steps = menu_steps(menu_modules(), {"device": dev})
    for name, step in steps:
        _, ms = timed(lambda: step(proj, state), name)
        with _plain_kernels(), _plain_fold():
            step(plain, plain_state)
        check(name, proj.canvas, plain.canvas)
        stage_ms[name] = ms
    if not np.array_equal(state["histogram"], plain_state["histogram"]):
        raise CheckFailed("menu path: the histogram differs from the plain route's")
    if not np.array_equal(state["field"].data, plain_state["field"].data):
        raise CheckFailed("menu path: the Liquify field differs from the plain route's")
    torch.cuda.synchronize()
    edited = _counts()
    pushed = len(proj.history.undo_stack)
    reads = sum(1 for name, _ in steps if name in MENU_READS)
    if pushed != len(steps) - reads:
        raise CheckFailed(f"menu path: {pushed} commands in the history after "
                          f"{len(steps)} steps ({reads} of them push none)")
    undos, undo_ms = timed(lambda: sum(1 for _ in iter(
        lambda: proj.history.undo(proj.canvas), False)))
    check("undo to the start", proj.canvas, load_pfe(str(src)))
    redos, redo_ms = timed(lambda: sum(1 for _ in iter(
        lambda: proj.history.redo(proj.canvas), False)))
    check("redo to the end", proj.canvas, plain.canvas)
    if undos != pushed or redos != pushed:
        raise CheckFailed(f"menu path: {undos} undos and {redos} redos of {pushed}")
    stage_ms.update({"undo to the start": undo_ms, "redo to the end": redo_ms})
    print(f"  menu: {len(steps)} steps, {pushed} commands in the history "
          f"({proj.history.memory_bytes() / 2**30:.2f} GiB), undone and redone; every "
          "layer equals the plain route's after each")

    c = proj.canvas
    runs = _raster_runs(c)
    _, stage_ms["flatten"] = timed(lambda: canvas_ops.flatten(c, device=dev), "flatten")
    with _plain_fold():
        canvas_ops.flatten(plain.canvas, device=dev)
    check("flatten", c, plain.canvas)
    _, stage_ms["save .pfe"] = timed(lambda: proj.save(root / "out.pfe"))
    _, stage_ms["save .png"] = timed(lambda: proj.save(root / "out.png"), "save .png")
    plain.save(root / "plain.pfe")
    with _plain_fold():
        plain.save(root / "plain.png")
    torch.cuda.synchronize()
    counts = _counts()
    for a, b in (("out.pfe", "plain.pfe"), ("out.png", "plain.png")):
        if (root / a).read_bytes() != (root / b).read_bytes():
            raise CheckFailed(f"menu path: {a} differs from the plain route's {b}")
    print("  ok  menu: flatten, out.pfe and out.png equal the plain route's")

    want = {name: 0 for name in counts}
    want["gather_bilinear_u8"] = MENU_WARPS
    want["gaussian_blur_fused"] = MENU_BLURS
    want["composite_stack_kernel"] = runs + 1
    print(f"  menu launches: edits {edited}, the whole path {counts} (expected {want}: "
          f"{runs} raster runs in the flatten, one for the .png save)")
    if counts != want:
        raise CheckFailed(f"menu path: launches {counts}, expected {want}")
    print(f"  menu stages at {w}x{h}, wall ms (device busy ms, from a torch.profiler "
          f"trace of the stage) [card: {card}]:")
    for name, ms in stage_ms.items():
        busy = f" (device busy {busy_ms[name]:.3f})" if name in busy_ms else ""
        print(f"    {name}: {ms:.1f}{busy}")
    wall = sum(stage_ms[name] for name in busy_ms)
    print(f"  menu: the card was busy {sum(busy_ms.values()):.1f} ms of the {wall:.1f} ms "
          f"the traced stages took ({sum(busy_ms.values()) / wall * 100:.2f}%), "
          f"{sum(stage_ms.values()) / 1e3:.1f} s of stages in all, host fields "
          f"{(dents_field_ms + contours_field_ms) / 1e3:.1f} s [card: {card}]")
    return counts


# ---------------------------------------------------------------------------
# The tools path: the painting and vector tools a scripting user of Project
# paints with (lasso, brush, pencil, eraser, dodge/burn/sponge, image tips,
# Bézier strokes, shapes, clone and heal, PatchMatch and the instant brush,
# the perspective crop), each stroke drawn into the canvas preview, shown
# through the dirty-rect composite and committed as one history command
# (tests/test_torch_tools_path.py runs the same steps against the JAX
# package on the CPU)
# ---------------------------------------------------------------------------

# polygons in fractions of (width, height)
TOOL_LASSOS = (
    ("lasso replace", "REPLACE", ((0.05, 0.15), (0.55, 0.05), (0.70, 0.45), (0.40, 0.90),
                                  (0.08, 0.75))),
    ("lasso add", "ADD", ((0.45, 0.20), (0.95, 0.15), (0.90, 0.85), (0.50, 0.70))),
    ("lasso intersect", "INTERSECT", ((0.02, 0.10), (0.98, 0.08), (0.96, 0.92),
                                      (0.50, 0.55), (0.03, 0.95))),
)
# (name, size and hardness at 3840x2160, anti-aliased, mode, extra
# properties, eraser, line start and end in fractions of (width, height)):
# lines about 2,000 px long at 3840x2160
TOOL_BRUSHES = (
    ("soft brush", 48.0, 0.2, True, "NORMAL", {}, False, (0.10, 0.30), (0.60, 0.45)),
    ("pencil", 8.0, 1.0, False, "NORMAL", {}, False, (0.15, 0.70), (0.65, 0.55)),
    ("eraser", 36.0, 0.6, True, "NORMAL", {}, True, (0.20, 0.40), (0.70, 0.60)),
    ("dodge", 60.0, 0.5, True, "DODGE", {}, False, (0.05, 0.50), (0.55, 0.35)),
    ("burn", 44.0, 0.8, True, "BURN", {}, False, (0.30, 0.20), (0.80, 0.35)),
    ("sponge", 52.0, 0.4, True, "SPONGE", {}, False, (0.25, 0.80), (0.75, 0.65)),
    ("scatter jitter", 24.0, 0.7, True, "NORMAL",
     {"scatter": 0.6, "hue_jitter": 0.5, "brightness_jitter": 0.4}, False,
     (0.35, 0.25), (0.85, 0.50)),
)
TOOL_TIP = ("Chalk", 64.0, 0.8, 30.0, 0.3, (0.12, 0.60), (0.62, 0.75))
TOOL_BEZIERS = (
    ("bezier solid", 10.0, "solid", "round", "none",
     ((0.10, 0.90), (0.30, 0.50), (0.60, 1.10), (0.90, 0.70))),
    ("bezier dashed arrows", 8.0, "dashed", "flat", "both",
     ((0.15, 0.15), (0.35, 0.45), (0.55, -0.10), (0.85, 0.30))),
)
# a custom shape of every command kind: cubic, smooth cubic, quadratic,
# smooth quadratic, an arc, relative moves and lines, two subpaths
TOOL_SVG = ('<svg viewBox="0 0 100 100"><path d="M10 10 C 20 0, 40 0, 50 10 '
            'S 80 20, 60 40 Q 50 60 30 50 T 10 40 A 12 8 30 1 0 10 10 Z '
            'm 5 5 h 10 v 10 l -10 0 z"/></svg>')
# (name, kind, fill mode, centre in fractions, half extents, rotation,
# outline width, corner radius; lengths at 3840x2160)
TOOL_SHAPES = (
    ("rounded rect", "ROUNDED_RECT", "FILLED", (0.30, 0.30), (300.0, 180.0), 0.0, 4.0, 40.0),
    ("star outline", "STAR5", "OUTLINE", (0.70, 0.35), (200.0, 200.0), 0.0, 6.0, 0.0),
    ("heart both", "HEART", "BOTH", (0.50, 0.60), (220.0, 200.0), 0.0, 8.0, 0.0),
    ("hexagon rotated", "HEXAGON", "FILLED", (0.20, 0.70), (160.0, 120.0), 0.6, 3.0, 0.0),
    ("custom shape", "RECTANGLE", "BOTH", (0.80, 0.70), (150.0, 150.0), 0.3, 5.0, 0.0),
)
TOOL_LAYER_SHAPE = ("ellipse on new layer", "ELLIPSE", "BOTH", (0.55, 0.45), (260.0, 170.0),
                    0.0, 10.0, 0.0)
TOOL_CLONE = (40.0, 0.5, (0.55, 0.20), (0.80, 0.50), (-0.10, 0.05))
TOOL_HEAL = (32.0, 0.6, (0.30, 0.50), (0.45, 0.62), 12.0)
TOOL_HOLE = ((0.62, 0.42), 128)  # centre in fractions, side in px at 3840x2160
TOOL_CROP = ((0.04, 0.06), (0.97, 0.02), (0.93, 0.95), (0.02, 0.90))
# the steps that change no pixels, and those that push a full-document snapshot
TOOL_SELECTS = tuple(name for name, *_ in TOOL_LASSOS) + ("select hole",)


def tool_modules(dev):
    """The port's modules of the tools path, by the names tool_steps reads,
    and its surface on `dev`: target (an array as a new tensor there),
    zeros (a blank u8 preview there), host (a tensor as a numpy array) and
    show (the dirty-rect composite on a DeviceLayerCache, K-composite on the
    card, counting its raster runs in state["composites"]).  The JAX
    package's modules carry the same names; its surface is numpy."""
    import types

    import numpy as np
    import torch

    from paintfe_tpu_torch.core import history, selection
    from paintfe_tpu_torch.core.device import (DeviceLayerCache, composite_device,
                                               composite_dirty_rect)
    from paintfe_tpu_torch.ops import canvas_ops, inpaint, shapes
    from paintfe_tpu_torch.tools import brush, brush_tips, clone_heal, vector_tools

    def target(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, copy=True)

    def zeros(h, w):
        return torch.zeros((h, w, 4), dtype=torch.uint8, device=dev)

    def show(c, rect, state):
        """The display after an edit: the dirty rect (x0, y0, x1, y1
        inclusive) spliced into the resident composite, or, for rect None,
        the whole composite anew."""
        if rect is None or "shown" not in state:
            state["cache"] = state.get("cache") or DeviceLayerCache(dev)
            state["shown"] = composite_device(c, state["cache"])
        else:
            composite_dirty_rect(c, state["cache"], state["shown"], rect)
        state["composites"] = state.get("composites", 0) + _raster_runs(c)

    return types.SimpleNamespace(
        brush=brush, brush_tips=brush_tips, clone_heal=clone_heal,
        vector_tools=vector_tools, shapes=shapes, inpaint=inpaint, selection=selection,
        history=history, canvas_ops=canvas_ops, target=target, zeros=zeros,
        host=lambda x: x.cpu().numpy(), show=show)


def tools_document(rng, h, w):
    """editing_document with a u16 deep-pixel buffer on the active layer
    (layer 2), which every commit to it keeps in sync."""
    from paintfe_tpu_torch.core.deep import DeepRgbaBuffer, PixelFormat

    doc = editing_document(rng, h, w)
    layer = doc.layers[doc.active_layer_index]
    layer.pixel_format = PixelFormat.RGBA_U16
    layer.deep_pixels = DeepRgbaBuffer.from_rgba8(layer.pixels, PixelFormat.RGBA_U16)
    return doc


def tool_steps(m, kw):
    """The edits of the tools path, in order, as (name, fn(project, state)
    -> stamps); `state` is a dict a run keeps (the displayed composite).
    Each stroke draws into canvas.preview (a blank one, or for Dodge, Burn
    and Sponge the layer itself with preview_replaces_layer), is shown
    through m.show over its dirty rect, and is committed with the canvas's
    _apply_preview over that rect as one PixelPatch; a commit to the layer
    with deep pixels syncs them over the rect.  Selections and the crop are
    SnapshotCommands, fills SingleLayerSnapshotCommands, the new layer a
    LayerOpCommand.  Lengths are given at 3840x2160 and scale with the
    canvas.  `m` holds the modules and the surface (tool_modules(dev), or
    the JAX package's by the same names); `kw` is passed to every call that
    does device work: {"device": dev} for the port, {} for the JAX
    package."""
    import math

    import numpy as np

    hist, sh = m.history, m.shapes

    def unit(c):
        return min(c.width / 3840.0, c.height / 2160.0)

    def at(c, f):
        return (f[0] * c.width, f[1] * c.height)

    def clamp(c, rect):
        x0, y0, x1, y1 = rect
        return (max(int(math.floor(x0)), 0), max(int(math.floor(y0)), 0),
                min(int(math.ceil(x1)), c.width - 1), min(int(math.ceil(y1)), c.height - 1))

    def around(c, points, margin):
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        return clamp(c, (min(xs) - margin, min(ys) - margin, max(xs) + margin,
                         max(ys) + margin))

    def commit(p, state, name, rect):
        """The preview's rect onto the active layer, one PixelPatch."""
        c = p.canvas
        idx = c.active_layer_index
        layer = c.layers[idx]
        before = layer.pixels
        x0, y0, x1, y1 = rect
        full = m.target(before)
        win = (slice(y0, y1 + 1), slice(x0, x1 + 1))
        full[win] = c._apply_preview(full[win], c.preview[win])
        after = np.ascontiguousarray(m.host(full))
        c.preview = None
        c.preview_is_eraser = c.preview_replaces_layer = False
        layer.pixels = after
        if layer.deep_pixels is not None:
            layer.deep_pixels.sync_region_from_u8(full, x0, y0, x1 + 1, y1 + 1)
        p.history.push(hist.PixelPatch(name, idx, before, after))

    def stroke(name, draw, eraser=False, replaces=False):
        """draw(canvas, preview) -> (dirty rect, stamps)"""
        def step(p, state):
            c = p.canvas
            layer = c.layers[c.active_layer_index]
            c.preview = m.target(layer.pixels) if replaces else m.zeros(c.height, c.width)
            c.preview_is_eraser, c.preview_replaces_layer = eraser, replaces
            rect, stamps = draw(c, c.preview)
            m.show(c, rect, state)
            commit(p, state, name, rect)
            return stamps
        return name, step

    def snapshot(name, edit, rect=None):
        """edit(canvas) under one SnapshotCommand; rect(canvas) is what to
        show after it (None: nothing, "all": the whole composite)"""
        def step(p, state):
            c = p.canvas
            cmd = hist.SnapshotCommand(name, c)
            edit(c)
            cmd.finalize(c)
            p.history.push(cmd)
            if rect is not None:
                m.show(c, None if rect == "all" else rect(c), state)
            return 0
        return name, step

    def lasso(name, mode, poly):
        return snapshot(name, lambda c: m.vector_tools.apply_lasso_selection(
            c, [at(c, f) for f in poly], m.selection.SelectionMode[mode]))

    def brush_line(name, size, hardness, aa, mode, props, eraser, a, b):
        def draw(c, preview):
            s = max(size * unit(c), 2.0)
            br = m.brush.Brush(s, hardness, aa, brush_mode=m.brush.BrushMode[mode])
            for key, value in props.items():
                setattr(br.properties, key, value)
            start, end = at(c, a), at(c, b)
            br.draw_line(preview, start, end, is_eraser=eraser,
                         primary=(0.85, 0.35, 0.2, 0.9), mask=c.selection)
            margin = s * (0.5 + props.get("scatter", 0.0)) + 2.0
            return around(c, (start, end), margin), br.stamp_counter
        return stroke(name, draw, eraser=eraser, replaces=mode != "NORMAL")

    def image_tip(c, preview):
        name, size, hardness, rotation, scatter, a, b = TOOL_TIP
        s = max(size * unit(c), 5.0)
        tip = m.brush_tips.stock_library().get(name)
        mask = m.target(m.brush_tips.rebuild_tip_mask(tip, s, hardness))
        start, end = at(c, a), at(c, b)
        step = max(s * 0.25, 1.0)
        n = int(math.hypot(end[0] - start[0], end[1] - start[1]) // step) + 1
        for k in range(n):
            t = k / max(n - 1, 1)
            pos = (start[0] + (end[0] - start[0]) * t, start[1] + (end[1] - start[1]) * t)
            rgb = m.brush_tips.jitter_color((200, 60, 40), 0.4, 0.2, pos, k)
            m.brush_tips.draw_image_tip(preview, pos, mask, rgb + (230,), flow=0.9,
                                        rotation_deg=rotation, scatter=scatter,
                                        stamp_counter=k, brush_size=s,
                                        selection=c.selection)
        margin = mask.shape[0] * 0.75 + scatter * s + 2.0
        return around(c, (start, end), margin), n

    def bezier(name, size, pattern, cap, arrows, cps):
        def draw(c, preview):
            s = max(size * unit(c), 2.0)
            points = [at(c, f) for f in cps]
            m.vector_tools.rasterize_bezier(preview, points, (30, 90, 220, 240), s,
                                            pattern=pattern, cap_style=cap,
                                            selection=c.selection, arrow_side=arrows)
            # the curve's samples, as rasterize_bezier steps them
            length = math.dist(points[0], points[3]) + sum(
                math.dist(a, b) for a, b in zip(points, points[1:]))
            samples = int(np.clip(np.ceil(length / max(s * 0.1, 0.5)), 20, 5000)) + 1
            return around(c, points, 6.0 * s + 16.0), samples
        return stroke(name, draw)

    def placed(c, kind, fill, centre, half, rotation, outline, corner, custom=None):
        u = unit(c)
        cx, cy = at(c, centre)
        return sh.PlacedShape(
            cx, cy, max(half[0] * u, 3.0), max(half[1] * u, 3.0), rotation,
            sh.ShapeKind[kind], sh.ShapeFillMode[fill], max(outline * u, 1.0),
            (230, 70, 40, 255), (40, 120, 220, 200), True, corner * u, custom)

    def shape(name, *spec):
        def draw(c, preview):
            custom = (sh.parse_custom_shape("custom", "tools",
                                            sh.extract_svg_path_data(TOOL_SVG))
                      if name == "custom shape" else None)
            buf, ox, oy = sh.rasterize_shape(placed(c, *spec, custom), c.width, c.height,
                                             **kw)
            bh, bw = buf.shape[:2]
            preview[oy:oy + bh, ox:ox + bw] = buf
            return clamp(c, (ox, oy, ox + bw - 1, oy + bh - 1)), 1
        return stroke(name, draw)

    def new_layer(p, state):
        c = p.canvas
        prev = c.active_layer_index
        idx = m.canvas_ops.add_layer(c, "shapes")
        p.history.push(hist.LayerOpCommand("new layer", "add", idx, c.layers[idx], prev, idx))
        return 0

    def merge(c):
        m.canvas_ops.merge_down(c, c.active_layer_index, **kw)
        layer = c.layers[c.active_layer_index]
        if layer.deep_pixels is not None:
            layer.deep_pixels.sync_region_from_u8(m.target(layer.pixels), 0, 0,
                                                  c.width, c.height)

    def clone(c, preview):
        size, hardness, a, b, offset = TOOL_CLONE
        br = m.brush.Brush(max(size * unit(c), 3.0), hardness)
        start, end = at(c, a), at(c, b)
        source = m.target(c.layers[c.active_layer_index].pixels)
        m.clone_heal.clone_stamp_line(br, preview, source, start, end, at(c, offset),
                                      c.selection)
        return (around(c, (start, end), br.properties.size / 2.0 + 2.0),
                len(m.clone_heal._line_points(start, end, c.width, c.height)))

    def heal(c, preview):
        size, hardness, a, b, radius = TOOL_HEAL
        br = m.brush.Brush(max(size * unit(c), 3.0), hardness)
        start, end = at(c, a), at(c, b)
        source = m.target(c.layers[c.active_layer_index].pixels)
        m.clone_heal.heal_line(br, preview, source, start, end,
                               max(radius * unit(c), 2.0), c.selection)
        return (around(c, (start, end), br.properties.size / 2.0 + 2.0),
                len(m.clone_heal._line_points(start, end, c.width, c.height)))

    def hole(c):
        (fx, fy), side = TOOL_HOLE
        side = max(int(side * unit(c)), 8)
        x0, y0 = int(fx * c.width) - side // 2, int(fy * c.height) - side // 2
        return x0, y0, x0 + side - 1, y0 + side - 1

    def fill(name, fn):
        """fn(canvas, pixels) -> the active layer's new pixels over the hole,
        one SingleLayerSnapshotCommand"""
        def step(p, state):
            c = p.canvas
            idx = c.active_layer_index
            layer = c.layers[idx]
            before = layer.pixels
            after = np.ascontiguousarray(fn(c, before), np.uint8)
            layer.pixels = after
            x0, y0, x1, y1 = hole(c)
            if layer.deep_pixels is not None:
                layer.deep_pixels.sync_region_from_u8(after, x0, y0, x1 + 1, y1 + 1)
            p.history.push(hist.SingleLayerSnapshotCommand(name, idx, before, after))
            m.show(c, hole(c), state)
            return 1
        return name, step

    def patchmatch(c, px):
        q = m.inpaint.ContentAwareQuality.BALANCED
        return m.inpaint.fill_region_patchmatch(px, c.selection, q.patch_size,
                                                q.patchmatch_iters)

    def instant(c, px):
        x0, y0, x1, y1 = hole(c)
        side = x1 - x0 + 1
        out = px.copy()
        for fx, fy in ((0.5, 0.5), (0.2, 0.2), (0.8, 0.2), (0.2, 0.8), (0.8, 0.8)):
            out = m.inpaint.inpaint_instant_brush(px, c.selection, out, x0 + fx * side,
                                                  y0 + fy * side, side * 0.3, side * 0.5,
                                                  0.5)
        return out

    steps = [lasso(*spec) for spec in TOOL_LASSOS]
    steps += [brush_line(*spec) for spec in TOOL_BRUSHES]
    steps += [stroke("image tip", image_tip)]
    steps += [bezier(*spec) for spec in TOOL_BEZIERS]
    steps += [shape(*spec) for spec in TOOL_SHAPES]
    steps += [("new layer", new_layer), shape(*TOOL_LAYER_SHAPE),
              snapshot("merge down", merge, "all"),
              stroke("clone", clone), stroke("heal", heal),
              snapshot("select hole", lambda c: setattr(c, "selection", m.selection.rect_mask(
                  c.width, c.height, *hole(c)))),
              fill("patchmatch", patchmatch), fill("instant brush", instant),
              snapshot("perspective crop", lambda c: m.vector_tools.apply_perspective_crop(
                  c, [at(c, f) for f in TOOL_CROP], **kw), "all")]
    return steps


def _tools_parts(p, state, stamps, cache):
    """What the tools path holds equal between the card and the CPU after a
    step, as {part: value}: the canvas's size, active layer, folders and
    selection, each layer's state with a BLAKE2b digest of its pixels, mask
    and deep buffer, the history's entries, the displayed composite's
    digest and the step's stamps.  `cache` keeps each host array's digest
    by identity (an array a step does not replace is hashed once; every
    edit assigns new arrays).  It reads only what the JAX package's
    documents hold too, so the tests compare the two packages with it."""
    import hashlib
    import weakref

    import numpy as np

    def digest(a):
        if a is None:
            return None
        if not isinstance(a, np.ndarray):  # a tensor on any device, or a JAX array
            a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        hit = cache.get(id(a))
        if hit is not None and hit[0]() is a:
            return hit[1]
        d = hashlib.blake2b(np.ascontiguousarray(a), digest_size=16).hexdigest()
        d = f"{a.dtype}{list(a.shape)}:{d}"
        cache[id(a)] = (weakref.ref(a), d)
        return d

    c = p.canvas
    parts = {"canvas": [c.width, c.height, c.active_layer_index],
             "folders": [[f.id, f.name, f.visible] for f in c.folders],
             "selection": digest(c.selection),
             "history": [type(cmd).__name__ + ":" + cmd.name for cmd in p.history.undo_stack],
             "stamps": stamps}
    for k, layer in enumerate(c.layers):
        deep = layer.deep_pixels
        parts[f"layer {k}"] = [
            layer.name, layer.visible, float(layer.opacity), int(layer.blend_mode),
            layer.mask_enabled, layer.folder_id, layer.content, digest(layer.pixels),
            digest(layer.mask),
            None if deep is None else [getattr(deep.format, "value", deep.format),
                                       digest(deep.data)]]
    if "shown" in state:
        parts["displayed composite"] = digest(state["shown"])
    return parts


def tool_stages(proj, state, dev, out):
    """The tools path's stages on `proj`, as (name, fn): the steps of
    tool_steps on `dev`, undo to the start, redo to the end, the flatten and
    Project.save to out.pfe and out.png (`out` a path without a suffix).
    A step's fn returns its stamps, undo's and redo's the commands they
    moved.  Both routes of drive_tools_path run these."""
    import torch

    from paintfe_tpu_torch.ops import canvas_ops

    def unwind(move):
        return sum(1 for _ in iter(lambda: move(proj.canvas), False))

    steps = tool_steps(tool_modules(torch.device(dev)), {"device": dev})
    return ([(name, lambda step=step: step(proj, state)) for name, step in steps]
            + [("undo to the start", lambda: unwind(proj.history.undo)),
               ("redo to the end", lambda: unwind(proj.history.redo)),
               ("flatten", lambda: canvas_ops.flatten(proj.canvas, device=dev)),
               ("save .pfe", lambda: proj.save(out.with_suffix(".pfe"))),
               ("save .png", lambda: proj.save(out.with_suffix(".png")))])


def _tools_cpu_route(src, root):
    """The tools path's stages with device="cpu", in a process of its own
    beside the card's: writes root/cpu_route.json (each stage's name, wall
    ms and parts, as _tools_parts gives them), cpu.pfe and cpu.png."""
    import torch

    from paintfe_tpu_torch.core.history import HistoryManager
    from paintfe_tpu_torch.core.project import Project

    # half the host's cores: the card's route runs beside this one
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    root = pathlib.Path(root)
    proj = Project.open(src, device="cpu")
    proj.history = HistoryManager(max_entries=100, memory_limit_bytes=64 << 30)
    state, cache, stages = {}, {}, []
    for name, fn in tool_stages(proj, state, "cpu", root / "cpu"):
        t0 = time.perf_counter()
        n = fn()
        ms = (time.perf_counter() - t0) * 1e3
        stages.append([name, ms, _tools_parts(proj, state, n, cache)])
    (root / "cpu_route.json").write_text(json.dumps(stages))


def drive_tools_path(dev, tmp, card):
    """The tools path at 3840x2160 on a six-layer document with a u16 deep
    layer (tools_document): Project.open of a .pfe, then the steps of
    tool_steps on the card (three lassos, seven brush lines of about 2,000
    px: soft, pencil, eraser, Dodge, Burn, Sponge, scatter with colour
    jitter; an image-tip stroke of a stock tip rotated 30 degrees; two
    Bézier strokes; five shapes; a shape on a new layer merged down; a
    clone and a heal stroke; PatchMatch and instant-brush dabs in a hole of
    128x128; the perspective crop), each stroke shown through the
    dirty-rect composite on K-composite and committed as one history
    command; undo to the start (equal to the opened document) and redo to
    the end; flatten and Project.save to .pfe and .png.  The same steps
    run with device="cpu" in a process of its own meanwhile
    (_tools_cpu_route): after every step every layer, mask, deep buffer,
    the selection, the history's entries, the displayed composite and the
    stamps must be the CPU's (BLAKE2b digests of the bytes, _tools_parts),
    and the saved files the CPU's byte for byte.  K-composite launches
    once a raster run of each display, once for the merge down, once a
    raster run of the flatten and once for the .png save; no other kernel.
    Prints each step's wall ms (untraced: the per-stage traces' stop and
    read took about 40 s, cut to keep the smoke under 800 s) beside the
    CPU's, each stroke's stamps a second, what the digests cost, and a
    soft line's stamps a second untraced with its operations a stamp
    traced.  Returns the launch counts of the path."""
    import multiprocessing

    import numpy as np

    from paintfe_tpu_torch.io.pfe import save_pfe

    h, w = UHD
    root = tmp / "tools"
    root.mkdir(parents=True)
    src = root / "doc.pfe"
    save_pfe(tools_document(np.random.default_rng(13), h, w), str(src))
    started = time.perf_counter()
    cpu_route = multiprocessing.get_context("spawn").Process(
        target=_tools_cpu_route, args=(str(src), str(root)), daemon=True)
    cpu_route.start()
    try:
        counts, stages, stage_ms, digests_s, line = _tools_card_route(dev, src, root)
        cpu_route.join(timeout=900)
        if cpu_route.exitcode != 0:
            raise CheckFailed(f"tools path: the CPU route exited with {cpu_route.exitcode}")
    finally:
        if cpu_route.is_alive():
            cpu_route.kill()
            cpu_route.join()
    phase_s = time.perf_counter() - started

    cpu_stages = json.loads((root / "cpu_route.json").read_text())
    if [name for name, *_ in stages] != [name for name, *_ in cpu_stages]:
        raise CheckFailed("tools path: the CPU route ran other stages")
    cpu_ms = {}
    for (name, ms, parts), (_, c_ms, cpu_parts) in zip(stages, cpu_stages):
        parts = json.loads(json.dumps(parts))
        diff = sorted(k for k in set(parts) | set(cpu_parts) if parts.get(k) != cpu_parts.get(k))
        if diff:
            raise CheckFailed(f"tools path, {name}: the card's document differs from the "
                              f"CPU route's: {diff}")
        cpu_ms[name] = c_ms
    for a, b in (("out.pfe", "cpu.pfe"), ("out.png", "cpu.png")):
        if (root / a).read_bytes() != (root / b).read_bytes():
            raise CheckFailed(f"tools path: {a} differs from the CPU route's {b}")
    print(f"  ok  tools: {len(stages) - 5} steps, undo to the start and redo to the end, "
          "the flatten and both saves: every layer, mask, deep buffer, the selection, "
          "history and the displayed composite equal the CPU route's after each; out.pfe "
          "and out.png equal its files")

    stamps = {name: parts["stamps"] for name, _, parts in stages
              if isinstance(parts["stamps"], int) and parts["stamps"] > 1
              and name not in ("undo to the start", "redo to the end")}
    print(f"  tools stages at {w}x{h}, wall ms untraced (a stroke's stamps and stamps a "
          f"second), the CPU route's ms beside [card: {card}]:")
    for name, ms in stage_ms.items():
        rate = (f", {stamps[name]} stamps, {stamps[name] / ms * 1e3:.0f} stamps/s"
                if name in stamps else "")
        cpu = f"; CPU {cpu_ms[name]:.1f}" if name in cpu_ms else ""
        print(f"    {name}: {ms:.1f}{rate}{cpu}")
    n, line_s, line_ops = line
    print(f"  tools: {sum(stage_ms.values()) / 1e3:.1f} s of stages in all (the CPU route "
          f"{sum(cpu_ms.values()) / 1e3:.1f} s beside them), the digests {digests_s:.1f} s; "
          f"PatchMatch {stage_ms['patchmatch']:.1f} ms, perspective crop "
          f"{stage_ms['perspective crop']:.1f} ms; one soft brush line untraced: "
          f"{n} stamps in {line_s * 1e3:.1f} ms ({n / line_s:.0f} stamps/s), traced "
          f"again: {line_ops} device operations ({line_ops / n:.1f} a stamp, "
          f"{line_s * 1e6 / line_ops:.1f} us an operation untraced); the phase "
          f"{phase_s:.1f} s [card: {card}]")
    return counts


def _tools_card_route(dev, src, root):
    """The tools path's stages on the card (drive_tools_path), untraced:
    returns the launch counts; each stage's [name, wall ms, parts]; the
    wall ms by stage; the seconds the digests took; and a soft brush
    line's stamps, untraced seconds and device operations traced."""
    import torch

    from paintfe_tpu_torch.core.history import HistoryManager
    from paintfe_tpu_torch.core.project import Project
    from paintfe_tpu_torch.io.pfe import load_pfe
    from paintfe_tpu_torch.tools import Brush

    h, w = UHD
    state, cache, stages = {}, {}, []
    _reset_counts()
    proj, open_ms = _timed_stage(lambda: Project.open(src, device=dev), {})
    proj.history = HistoryManager(max_entries=100, memory_limit_bytes=64 << 30)
    stage_ms = {"open": open_ms}
    digests_s = 0.0
    for name, fn in tool_stages(proj, state, dev, root / "out"):
        if name == "undo to the start":
            torch.cuda.synchronize()
            edited = _counts()
            pushed = len(proj.history.undo_stack)
            if pushed != len(stages):
                raise CheckFailed(f"tools path: {pushed} commands in the history after "
                                  f"{len(stages)} steps")
        elif name == "flatten":
            runs = _raster_runs(proj.canvas)
        n, ms = _timed_stage(fn, {})
        t1 = time.perf_counter()
        stage_ms[name] = ms
        stages.append([name, ms, _tools_parts(proj, state, n, cache)])
        digests_s += time.perf_counter() - t1
        if name == "undo to the start":
            diff = document_differences(proj.canvas, load_pfe(str(src)))
            if diff:
                raise CheckFailed("tools path: undo to the start differs from the opened "
                                  f"document: {diff}")
    torch.cuda.synchronize()
    counts = _counts()
    moved = {name: parts["stamps"] for name, _, parts in stages}
    if moved["undo to the start"] != pushed or moved["redo to the end"] != pushed:
        raise CheckFailed(f"tools path: {moved['undo to the start']} undos and "
                          f"{moved['redo to the end']} redos of {pushed}")
    if document_differences(load_pfe(str(root / "out.pfe")), proj.canvas):
        raise CheckFailed("tools path: the saved .pfe reopens to another document")

    want = {name: 0 for name in counts}
    want["composite_stack_kernel"] = state["composites"] + 1 + runs + 1
    print(f"  tools: {pushed} steps, {pushed} commands in the history "
          f"({proj.history.memory_bytes() / 2**30:.2f} GiB); launches: edits {edited}, "
          f"the whole path {counts} (expected {want}: {state['composites']} raster runs "
          f"over the displays, one for the merge down, {runs} in the flatten, one for "
          "the .png save)")
    if counts != want:
        raise CheckFailed(f"tools path: launches {counts}, expected {want}")

    # a soft brush line on a scratch preview: untraced, its stamps a second;
    # then again traced, its device operations
    preview = torch.zeros((h, w, 4), dtype=torch.uint8, device=dev)

    def line():
        brush = Brush(48.0, 0.2, True)
        brush.draw_line(preview, (0.10 * w, 0.30 * h), (0.60 * w, 0.45 * h),
                        primary=(0.85, 0.35, 0.2, 0.9))
        return brush.stamp_counter

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = line()
    torch.cuda.synchronize()
    line_s = time.perf_counter() - t0
    line_ops = {}
    _timed_stage(line, {}, "line", line_ops)
    return counts, stages, stage_ms, digests_s, (n, line_s, line_ops["line"])


# ---------------------------------------------------------------------------
# The inputs path: 16-bit PNG and TIFF, .pdn and .pfe text documents,
# --animate and --trace-dir
# ---------------------------------------------------------------------------

# the text document's caption: an outline and a shadow of blur radius 6
TEXT_SHADOW_BLUR = 6.0
# the --animate APNG's 4K PNG frames (four until the multi-GPU path needed
# the time), before the .pdn's
ANIMATE_UHD_FRAMES = 2
PDN_BLENDS = ("Normal", "Multiply", "Screen", "Overlay", "Additive", "Difference")


def _ramp(rng, h, w, ch, scale, k):
    """Smooth ramps plus noise in [0, scale], f32: the content of a scan or
    a render, which compresses as such files do."""
    import numpy as np

    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    c = np.arange(ch, dtype=np.float32)[None, None, :]
    v = np.sin(np.float32(6.0) * xx + np.float32(4.0) * yy * (np.float32(1.0) + np.float32(0.3) * c)
               + np.float32(k) + c)
    v *= np.float32(0.45 * scale)
    v += np.float32(0.5 * scale)
    v += rng.integers(0, max(scale // 64, 1), (h, w, ch), dtype=np.uint16)
    return np.clip(v, 0, scale, out=v)


def _input_files(root, seed=41):
    """The inputs path's files, written from `seed`: two 16-bit RGBA 4K PNGs
    whose rows cycle PNG filters 0-4, a 16-bit 4K TIFF with deflate and one
    with LZW (decoded in C++), a six-layer 4K .pdn and a 4K .pfe with a
    raster layer and a text layer (outline, and a shadow of blur radius
    TEXT_SHADOW_BLUR); and for --animate ANIMATE_UHD_FRAMES 8-bit 4K PNGs
    and three 1920x1080 ones (GIF palettes trained in C++)."""
    import numpy as np
    from PIL import Image

    from paintfe_tpu_torch.core.canvas import Canvas, Layer
    from paintfe_tpu_torch.io.deep_export import write_tiff16
    from paintfe_tpu_torch.io.pfe import save_pfe
    from paintfe_tpu_torch.ops import text_layer as tl

    rng = np.random.default_rng(seed)
    h, w = UHD
    (root / "in").mkdir(parents=True)
    (root / "anim").mkdir()
    (root / "gif").mkdir()
    t0 = time.perf_counter()
    for k in range(2):
        px = _ramp(rng, h, w, 4, 65535, k).astype(np.uint16)
        px[:128, :, 3] = 0
        (root / "in" / f"p{k}.png").write_bytes(png16_bytes(px))
    write_tiff16(root / "in" / "t0.tif", w, h, _ramp(rng, h, w, 4, 65535, 2).astype(np.uint16),
                 "deflate")
    write_tiff16(root / "in" / "t1.tif", w, h, _ramp(rng, h, w, 4, 65535, 3).astype(np.uint16),
                 "lzw")
    layers = []
    for k, blend in enumerate(PDN_BLENDS):
        px = _ramp(rng, h, w, 4, 255, 4 + k).astype(np.uint8)
        if k == 0:
            px[..., 3] = 255
        layers.append(dict(name=f"layer {k}", pixels=px, blend=blend, visible=k != 4,
                           opacity=255 - 20 * k))
    (root / "in" / "d0.pdn").write_bytes(pdn_bytes(layers, w, h))
    doc = Canvas.new(w, h)
    doc.layers[0].pixels = _ramp(rng, h, w, 4, 255, 11).astype(np.uint8)
    doc.layers[0].pixels[..., 3] = 255
    text = Layer.new("caption", w, h)
    text.content = "text"
    text.text_data = tl.make_text_layer_data("Inputs path\nat 3840x2160", 200, 300, size=260,
                                             color=(250, 245, 235, 255))
    text.text_data.effects.outline = tl.OutlineEffect((20, 20, 120, 255), 4.0)
    text.text_data.effects.shadow = tl.ShadowEffect((0, 0, 0, 170), 14.0, 12.0,
                                                    TEXT_SHADOW_BLUR, 2.0)
    doc.layers.append(text)
    save_pfe(doc, str(root / "in" / "x0.pfe"))
    for k in range(ANIMATE_UHD_FRAMES):
        Image.fromarray(_ramp(rng, h, w, 4, 255, 20 + k).astype(np.uint8), "RGBA").save(
            root / "anim" / f"a{k}.png", compress_level=1)
    for k in range(3):
        Image.fromarray(_ramp(rng, *FHD, 4, 255, 30 + k).astype(np.uint8), "RGBA").save(
            root / "gif" / f"g{k}.png", compress_level=1)
    print(f"  inputs: wrote 2 16-bit PNGs, 2 16-bit TIFFs, a .pdn, a text .pfe "
          f"(3840x2160) and the --animate frames "
          f"({time.perf_counter() - t0:.3f} s)")


def _same_files(tag, got_dir, want_dir):
    """Every file of want_dir (the CPU run) is in got_dir with its bytes."""
    names = sorted(p.name for p in want_dir.iterdir())
    if sorted(p.name for p in got_dir.iterdir()) != names or not names:
        raise CheckFailed(f"{tag}: the card's outputs {sorted(p.name for p in got_dir.iterdir())}"
                          f" differ from the CPU run's {names}")
    for name in names:
        if (got_dir / name).read_bytes() != (want_dir / name).read_bytes():
            raise CheckFailed(f"{tag}: {name} differs from the CPU run's bytes")
    return names


def _background_cli(runs, workers=2):
    """Run each argv of `runs` ((tag, argv) pairs) through the CLI in a
    process of its own, `workers` processes at a time, on threads; returns
    one future of (exit code, seconds) a run, in order.  The processes take
    3 CPU threads each (the card's runs go on beside them); a future is
    done when its process has ended."""
    import concurrent.futures
    import os

    env = dict(os.environ, OMP_NUM_THREADS="3")
    here = pathlib.Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(here), env.get("PYTHONPATH")]))

    def go(tag, argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "paintfe_tpu_torch.cli", *argv],
                              cwd=here, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"  {tag} --device cpu: rc {proc.returncode}\n{proc.stderr[-2000:]}")
        return proc.returncode, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    futures = [pool.submit(go, tag, argv) for tag, argv in runs]
    pool.shutdown(wait=False)
    return futures


def _trace_kernel_names(d):
    names = set()
    for f in d.glob("*.json"):
        for e in json.loads(f.read_text()).get("traceEvents", []):
            if e.get("cat") == "kernel":
                names.add(e.get("name", ""))
    return names


def drive_inputs_path(dev, tmp):
    """The inputs path at 3840x2160: the headline script over 16-bit PNGs
    (rows of every PNG filter), 16-bit TIFFs, a six-layer .pdn and a .pfe
    with a text layer, through the serial CLI (-f png, and -f tiff on the
    PNGs) and --shard (both); --animate to APNG over two 4K PNGs and the
    .pdn, serially and under --shard, and to GIF at 1920x1080; one serial run
    under --trace-dir.  Every file of a CLI run must equal the same run's
    with --device cpu, byte for byte; K-blur and K-composite launch exactly
    as often as the path needs.  The files stay under tmp / "inputs"."""
    from paintfe_tpu_torch import cli

    root = tmp / "inputs"
    _input_files(root)
    (root / "fx.rhai").write_text(HEADLINE)
    ins = root / "in"
    script = ["-s", str(root / "fx.rhai")]
    deep_pngs = [str(ins / "p0.png"), str(ins / "p1.png")]
    everything = [str(ins / "*")]
    # tag: (inputs, extra arguments, output, K-blur and K-composite launches on
    # the card).  Serially: one K-blur a script run and one for the text
    # shadow; one K-composite a flatten (.pdn, text document: one raster run
    # each); the deep inputs export their exact 16-bit payload, no flatten.
    # --shard: one K-blur for the one shape bucket (p0, p1, t0, t1 at 4K),
    # the documents on the serial canvas path.
    runs = {
        "serial png": (everything, ["-f", "png", "--profile"], "png", (7, 2)),
        "serial tiff": (deep_pngs, ["-f", "tiff"], "tiff", (2, 0)),
        "shard png": (everything, ["-f", "png", "--shard"], "shard_png", (4, 2)),
        "shard tiff": (deep_pngs, ["-f", "tiff", "--shard"], "shard_tiff", (1, 0)),
    }
    # the same runs with --device cpu, in processes of their own beside the
    # card's runs here; their files are compared at the end of the phase
    cpu = _background_cli([(f"inputs {tag}", ["-i", *inputs, *script, *extra, "--output-dir",
                                             str(root / f"cpu_{out}"), "--device", "cpu"])
                           for tag, (inputs, extra, out, _) in runs.items()])
    try:
        for tag, (inputs, extra, out, (n_blur, n_comp)) in runs.items():
            c0 = _counts()
            t0 = time.perf_counter()
            rc = cli.main(["-i", *inputs, *script, *extra, "--output-dir",
                           str(root / f"out_{out}"), "--device", "cuda"])
            t1 = time.perf_counter()
            c1 = _counts()
            got = (c1["gaussian_blur_fused"] - c0["gaussian_blur_fused"],
                   c1["composite_stack_kernel"] - c0["composite_stack_kernel"])
            print(f"  inputs {tag}: rc {rc} ({t1 - t0:.3f} s on the card); K-blur {got[0]}, "
                  f"K-composite {got[1]} launches")
            if rc != 0:
                raise CheckFailed(f"inputs {tag}: CLI exit code {rc}")
            if got != (n_blur, n_comp):
                raise CheckFailed(f"inputs {tag}: launched K-blur {got[0]} and K-composite "
                                  f"{got[1]} times, expected {n_blur} and {n_comp}")
        for name in ("p0.png", "t0.png"):  # the deep payload survived, serially
            if (root / "out_png" / name).read_bytes()[24] != 16:
                raise CheckFailed(f"inputs: {name} was not written as a 16-bit PNG")
        _drive_animate_and_trace(root, script)
    finally:
        cpu_results = [f.result() for f in cpu]
    for (tag, (_, _, out, _)), (rc_cpu, seconds) in zip(runs.items(), cpu_results):
        if rc_cpu != 0:
            raise CheckFailed(f"inputs {tag}: the --device cpu run's exit code {rc_cpu}")
        names = _same_files(f"inputs {tag}", root / f"out_{out}", root / f"cpu_{out}")
        print(f"  ok  inputs {tag}: {len(names)} files equal the --device cpu run's bytes "
              f"(that run {seconds:.3f} s, beside the card's)")


def _drive_animate_and_trace(root, script):
    """--animate to APNG over ANIMATE_UHD_FRAMES 4K PNGs and the .pdn, serially (one
    K-blur a frame, one K-composite for the .pdn) and under --shard (one
    K-blur for the 4K bucket, one for the .pdn), equal files; GIF at
    1920x1080 both ways; then one serial run of the text document under
    --trace-dir, whose trace must name K-blur's and K-composite's
    kernels."""
    from paintfe_tpu_torch import cli

    ins = root / "in"
    anim_in = [str(root / "anim" / "*.png"), str(ins / "d0.pdn")]
    gif_in = [str(root / "gif" / "*.png")]
    n_apng = ANIMATE_UHD_FRAMES + 1
    animations = {"apng serial": (anim_in, [], "a.png", (n_apng, 1)),
                  "apng shard": (anim_in, ["--shard"], "a_shard.png", (2, 1)),
                  "gif serial": (gif_in, [], "g.gif", (3, 0)),
                  "gif shard": (gif_in, ["--shard"], "g_shard.gif", (1, 0))}
    for tag, (inputs, extra, out, (n_blur, n_comp)) in animations.items():
        c0 = _counts()
        t0 = time.perf_counter()
        rc = cli.main(["-i", *inputs, *script, "--animate", str(root / out), "--fps", "8",
                       "--device", "cuda", *extra])
        t1 = time.perf_counter()
        c1 = _counts()
        got = (c1["gaussian_blur_fused"] - c0["gaussian_blur_fused"],
               c1["composite_stack_kernel"] - c0["composite_stack_kernel"])
        print(f"  inputs --animate {tag}: rc {rc} ({t1 - t0:.3f} s); K-blur {got[0]}, "
              f"K-composite {got[1]} launches")
        if rc != 0:
            raise CheckFailed(f"inputs --animate {tag}: CLI exit code {rc}")
        if got != (n_blur, n_comp):
            raise CheckFailed(f"inputs --animate {tag}: launched K-blur {got[0]} and "
                              f"K-composite {got[1]} times, expected {n_blur} and {n_comp}")
    from paintfe_tpu_torch.io.codecs import load_frames

    for serial, shard, n in (("a.png", "a_shard.png", n_apng), ("g.gif", "g_shard.gif", 3)):
        frames, _ = load_frames(root / serial)
        if len(frames) != n or (root / serial).read_bytes() != (root / shard).read_bytes():
            raise CheckFailed(f"inputs --animate: {shard} differs from {serial} "
                              f"({len(frames)} frames, expected {n})")
    print(f"  ok  inputs --animate: APNG ({n_apng} frames) and GIF (3 frames) equal under "
          "--shard and serially")

    # --trace-dir: the text document, serially
    c0 = _counts()
    rc = cli.main(["-i", str(ins / "x0.pfe"), *script, "--output-dir", str(root / "out_trace"),
                   "--trace-dir", str(root / "trace"), "--device", "cuda"])
    kernels = _trace_kernel_names(root / "trace")
    c1 = _counts()
    print(f"  inputs --trace-dir: rc {rc}; {len(kernels)} kernel names in the trace")
    if rc != 0 or not any("blur_tiled_kernel" in k for k in kernels) or not any(
            "composite_kernel" in k for k in kernels):
        raise CheckFailed(f"inputs --trace-dir: rc {rc}, the trace names no K-blur or no "
                          f"K-composite kernel: {sorted(kernels)[:12]}")
    if (c1["gaussian_blur_fused"] - c0["gaussian_blur_fused"],
            c1["composite_stack_kernel"] - c0["composite_stack_kernel"]) != (2, 1):
        raise CheckFailed("inputs --trace-dir: expected 2 K-blur and 1 K-composite launches")
    print("  ok  inputs --trace-dir: the trace names blur_tiled_kernel and composite_kernel")


def time_input_stages(dev, root, card):
    """The inputs path's stages on one input each, timed alone: the 16-bit
    PNG load (zlib, then the defilter in C++, and the pure-Python defilter
    on a tenth of the rows), the 16-bit TIFF loads (deflate, LZW), the .pdn
    load (NRBF graph, gzip payloads) and
    its flatten on the card, the text rasterise (glyphs, outline, shadow on
    the card), and the 16-bit PNG and TIFF encodes."""
    import struct
    import zlib

    import numpy as np
    import torch

    from paintfe_tpu_torch.io import deep_export, pdn
    from paintfe_tpu_torch.io.nrbf import NrbfReader
    from paintfe_tpu_torch.io.pfe import load_pfe

    ins = root / "in"

    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    blob = (ins / "p0.png").read_bytes()
    pos, idat = 8, bytearray()
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        if blob[pos + 4:pos + 8] == b"IDAT":
            idat += blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    h, w = UHD
    stride = w * 8
    raw, zlib_ms = wall(lambda: zlib.decompress(bytes(idat)))
    _, native_ms = wall(lambda: deep_export.png_defilter(raw, h, stride, 8))
    rows = h // 10
    _, plain_ms = wall(lambda: deep_export.png_defilter_plain(raw[:rows * (stride + 1)], rows,
                                                              stride, 8))
    _, png_load_ms = wall(lambda: deep_export.load_deep_image(ins / "p0.png"))
    _, tiff_load_ms = wall(lambda: deep_export.load_deep_image(ins / "t0.tif"))
    _, lzw_load_ms = wall(lambda: deep_export.load_deep_image(ins / "t1.tif"))
    data = (ins / "d0.pdn").read_bytes()
    hlen = data[4] | data[5] << 8 | data[6] << 16
    reader, nrbf_ms = wall(lambda: NrbfReader(data, 7 + hlen + 2).parse())
    blocks = [o for o in reader.find_instances("MemoryBlock") if o.get("deferred")]

    def gunzip():
        at = reader.end_pos
        for b in blocks:
            _, at = pdn._read_deferred(data, at, int(b.get("length64")))

    _, gzip_ms = wall(gunzip)
    doc, pdn_ms = wall(lambda: pdn.load_pdn(ins / "d0.pdn"))
    _, flatten_ms = wall(lambda: doc.composite(device=dev))
    text_doc = load_pfe(str(ins / "x0.pfe"))
    td = text_doc.layers[1].text_data
    _, text_ms = wall(lambda: td.rasterize(w, h, dev))
    td.mark_dirty()
    _, text_cpu_ms = wall(lambda: td.rasterize(w, h, "cpu"))
    px = np.zeros((h, w, 4), np.uint16)
    _, png16_ms = wall(lambda: deep_export.write_png16(root / "enc.png", w, h, px))
    _, tiff16_ms = wall(lambda: deep_export.write_tiff16(root / "enc.tif", w, h, px, "none"))
    print(f"inputs path stages, one 3840x2160 input each, wall [card: {card}]:")
    print(f"  16-bit PNG load {png_load_ms:.1f} ms: zlib {zlib_ms:.1f} ms, defilter in C++ "
          f"{native_ms:.1f} ms, pure-Python defilter {plain_ms:.1f} ms for {rows} of {h} rows "
          f"(rows of filters 0-4 in turn)")
    print(f"  16-bit TIFF load: deflate {tiff_load_ms:.1f} ms, LZW (decoded in C++) "
          f"{lzw_load_ms:.1f} ms")
    print(f"  .pdn (6 layers) load {pdn_ms:.1f} ms: NRBF graph {nrbf_ms:.1f} ms, gzip payloads "
          f"{gzip_ms:.1f} ms; flatten on the card {flatten_ms:.1f} ms")
    print(f"  text rasterise {text_ms:.1f} ms with its effects on the card, {text_cpu_ms:.1f} ms "
          f"with them on the CPU")
    print(f"  encode: 16-bit PNG {png16_ms:.1f} ms, 16-bit TIFF (none) {tiff16_ms:.1f} ms")


RAW_SIZE = (4000, 6000)  # rows x columns: a 24 MP APS-C sensor
# the lossless-JPEG Huffman table (tests/ljpeg_writer.py's): code lengths of
# the SSSS categories 0-16, canonical codes
LJPEG_CODE_LENGTHS = (2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)
_TIFF_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 10: 8}


def tiff_bytes(ifds, blobs=(), magic=42, extra=b""):
    """A little-endian TIFF container.  `ifds` is a list of (entries, next):
    entries {tag: (type, values)}, next the index of the IFD chained after
    it or None.  A value ("ifd", i) or ("blob", i) stands for that IFD's or
    blob's file offset; as the whole value of a type-7 entry it makes the
    entry point at that IFD's directory or that blob.  Rationals are
    (numerator, denominator) pairs, ASCII values str.  The file is the
    header (then `extra`), each IFD followed by its out-of-line values, then
    the blobs."""
    import struct

    dir_size = [2 + 12 * len(entries) + 4 for entries, _ in ifds]

    def pointee(v):
        return isinstance(v, tuple) and v[0] in ("ifd", "blob")

    def count(typ, v):
        if pointee(v):
            return dir_size[v[1]] if v[0] == "ifd" else len(blobs[v[1]])
        return len(v) + 1 if typ == 2 else len(v)

    ifd_off, pos = [], 8 + len(extra)
    for entries, _ in ifds:
        ifd_off.append(pos)
        pos += 2 + 12 * len(entries) + 4
        for typ, v in entries.values():
            n = 0 if pointee(v) else _TIFF_TYPE_SIZE[typ] * count(typ, v)
            pos += n + (n & 1) if n > 4 else 0
    blob_off = []
    for b in blobs:
        blob_off.append(pos)
        pos += len(b)

    def resolve(x):
        return (ifd_off if x[0] == "ifd" else blob_off)[x[1]] if isinstance(x, tuple) else x

    def pack(typ, v):
        if typ == 2:
            return v.encode() + b"\0"
        if typ in (1, 7):
            return bytes(v)
        if typ in (5, 10):
            return b"".join(struct.pack("<II" if typ == 5 else "<ii", *p) for p in v)
        return struct.pack(f"<{len(v)}{'H' if typ == 3 else 'I'}", *map(resolve, v))

    out = bytearray(b"II" + struct.pack("<HI", magic, ifd_off[0]) + extra)
    for i, (entries, nxt) in enumerate(ifds):
        area, area_at = bytearray(), ifd_off[i] + dir_size[i]
        out += struct.pack("<H", len(entries))
        for tag in sorted(entries):
            typ, v = entries[tag]
            if pointee(v):
                out += struct.pack("<HHII", tag, typ, count(typ, v), resolve(v))
                continue
            data = pack(typ, v)
            if len(data) <= 4:
                out += struct.pack("<HHI", tag, typ, count(typ, v)) + data.ljust(4, b"\0")
            else:
                out += struct.pack("<HHII", tag, typ, count(typ, v), area_at + len(area))
                area += data + b"\0" * (len(data) & 1)
        out += struct.pack("<I", ifd_off[nxt] if nxt is not None else 0)
        out += area
    for b in blobs:
        out += b
    return bytes(out)


def ljpeg_bytes(samples, precision):
    """A lossless JPEG (SOF3) of u16 samples [H, W] or [H, W, C], components
    interleaved along the row: predictor 1, no point transform, no restarts,
    the Huffman table LJPEG_CODE_LENGTHS; the bytes tests/ljpeg_writer.py
    writes for the same arguments, built with numpy rather than bit by bit."""
    import numpy as np

    s = np.asarray(samples, np.int64)
    if s.ndim == 2:
        s = s[..., None]
    h, w, nc = s.shape
    order = sorted(range(17), key=lambda k: (LJPEG_CODE_LENGTHS[k], k))
    codes, code, prev = np.zeros(17, np.int64), 0, 0
    for sym in order:
        code <<= LJPEG_CODE_LENGTHS[sym] - prev
        codes[sym], prev = code, LJPEG_CODE_LENGTHS[sym]
        code += 1
    lengths = np.array(LJPEG_CODE_LENGTHS, np.int64)
    # predictor 1: the left neighbour; the first column the one above; the
    # first sample 2^(P-1)
    pred = np.empty_like(s)
    pred[:, 1:] = s[:, :-1]
    pred[1:, 0] = s[:-1, 0]
    pred[0, 0] = 1 << (precision - 1)
    d = ((s - pred) & 0xFFFF).reshape(-1)
    half = d == 32768  # category 16: no extra bits
    d = np.where(d > 32768, d - 65536, d)
    ssss = np.where(half, 16, np.frexp(np.abs(d).astype(np.float64))[1]).astype(np.int64)
    extra_n = np.where(half, 0, ssss)
    extra = np.where(d > 0, d, d + (1 << extra_n) - 1) & ((1 << extra_n) - 1)
    values = (codes[ssss] << extra_n) | extra
    nbits = lengths[ssss] + extra_n
    total = int(nbits.sum())
    pad = -total % 8  # the last byte filled with 1 bits
    values = np.append(values, (1 << pad) - 1)
    nbits = np.append(nbits, pad)
    # each field lands in one or two big-endian 32-bit words; fields never
    # share a bit, so the words are sums (exact in f64 below 2^53)
    off = np.cumsum(nbits) - nbits
    word, bit = off // 32, off % 32
    spill = bit + nbits - 32
    first = np.where(spill > 0, values >> np.maximum(spill, 0),
                     values << np.maximum(-spill, 0))
    second = np.where(spill > 0, (values & ((1 << np.maximum(spill, 0)) - 1))
                      << (32 - np.maximum(spill, 0)), 0)
    n_words = (total + pad) // 32 + 2
    words = (np.bincount(word, first.astype(np.float64), n_words)
             + np.bincount(word + 1, second.astype(np.float64), n_words))
    data = words.astype(np.uint64).astype(">u4").view(np.uint8)[:(total + pad) // 8]
    data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0)  # byte stuffing

    def segment(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + bytes(payload)

    bits = [0] * 17
    for n in LJPEG_CODE_LENGTHS:
        bits[n] += 1
    sof = [precision, *h.to_bytes(2, "big"), *w.to_bytes(2, "big"), nc]
    sos = [nc]
    for c in range(nc):
        sof += [c + 1, 0x11, 0]
        sos += [c + 1, 0x00]
    return (b"\xff\xd8" + segment(0xC4, [0x00] + bits[1:] + order) + segment(0xC3, sof)
            + segment(0xDA, sos + [1, 0, 0]) + data.tobytes() + b"\xff\xd9")


def raw_mosaic(rng, h, w, lo, hi, k):
    """A CFA mosaic of integer samples in [lo, hi], u16: a smooth scene
    (waves and ramps, each 2x2 site its own channel gain) plus noise, so
    that the demosaic and the sRGB curve see real values."""
    import numpy as np

    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    scene = (np.float32(0.45) + np.float32(0.3) * np.sin(np.float32(7.0) * x + np.float32(k))
             * np.cos(np.float32(5.0) * y - np.float32(0.5 * k)) + np.float32(0.2) * x * y)
    gain = np.array([[0.55, 0.9], [0.9, 0.7]], np.float32)
    scene = scene * np.tile(gain, ((h + 1) // 2, (w + 1) // 2))[:h, :w]
    v = lo + scene * np.float32(hi - lo) + rng.normal(0.0, (hi - lo) / 400, (h, w)).astype(
        np.float32)
    return np.clip(np.rint(v), lo, hi).astype(np.uint16)


def _pack_msb(samples, bits):
    """An MSB-first continuous bitstream of `bits`-wide samples (14 bits:
    four samples in seven bytes)."""
    import numpy as np

    s = samples.reshape(-1).astype(np.uint64)
    per = 8 // np.gcd(bits, 8)  # samples a group
    s = np.append(s, np.zeros(-len(s) % per, np.uint64)).reshape(-1, per)
    acc = np.zeros(len(s), np.uint64)
    for j in range(per):
        acc = (acc << np.uint64(bits)) | s[:, j]
    nbytes = per * bits // 8
    out = np.stack([(acc >> np.uint64(8 * (nbytes - 1 - b))) & np.uint64(0xFF)
                    for b in range(nbytes)], axis=1).astype(np.uint8)
    return out.reshape(-1)[:(samples.size * bits + 7) // 8].tobytes()


def _dng_entries(h, w, cfa, extra, segments, tile=None, bits=16, compression=1,
                 rows_per_strip=None):
    """One DNG raw IFD (CFA photometric) over `segments` (blob indices)."""
    e = {254: (4, [0]), 256: (4, [w]), 257: (4, [h]), 258: (3, [bits]), 259: (3, [compression]),
         262: (3, [32803]), 277: (3, [1]), 50706: (1, [1, 4, 0, 0]),
         33421: (3, [2, 2]), 33422: (1, list(cfa))}
    refs = [("blob", i) for i in segments]
    if tile is None:
        e.update({278: (4, [rows_per_strip or h]), 273: (4, refs), 279: (4, [0] * len(refs))})
    else:
        e.update({322: (4, [tile]), 323: (4, [tile]), 324: (4, refs), 325: (4, [0] * len(refs))})
    e.update(extra)
    return e


def _with_counts(ifds, blobs):
    """Fill each strip/tile byte-count entry from the blobs its offsets
    name."""
    for entries, _ in ifds:
        for off_tag, cnt_tag in ((273, 279), (324, 325)):
            if off_tag in entries:
                refs = entries[off_tag][1]
                entries[cnt_tag] = (4, [len(blobs[i]) for _, i in refs])
    return ifds


def raw_files(root, h, w, seed=51):
    """The RAW phase's camera files at h x w, written from `seed` into
    `root`: a name -> (family, output shape) map.  DNG: 16-bit strips with a
    per-site BlackLevel (BlackLevelRepeatDim), AsShotNeutral, ColorMatrix1
    and an ActiveArea; deflate tiles with predictor 2; lossless-JPEG tiles;
    LZW strips with predictor 2.  CR2: a 14-bit lossless-JPEG stream in
    three Canon slices, SensorInfo (masked left border: the black level)
    and ColorData as-shot levels.  NEF: 14-bit packed, a Nikon MakerNote
    white balance.  ARW: 16-bit strips with TIFF/EP levels and
    AsShotNeutral.  RW2: magic 85, sensor borders, per-colour blacks and
    balances."""
    import zlib

    import numpy as np

    from paintfe_tpu_torch.io.deep_export import _lzw_encode

    rng = np.random.default_rng(seed)
    files = {}
    tile = 512
    cm = [(7034, 10000), (-804, 10000), (-1014, 10000), (-4420, 10000), (11564, 10000),
          (3206, 10000), (-852, 10000), (2048, 10000), (6148, 10000)]

    def tiles_of(m):
        th, tw = -(-h // tile), -(-w // tile)
        padded = np.zeros((th * tile, tw * tile), m.dtype)
        padded[:h, :w] = m
        return [padded[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile]
                for ty in range(th) for tx in range(tw)]

    def predict2(m):
        d = m.copy()
        d[:, 1:] = m[:, 1:] - m[:, :-1]  # modular u16 differences
        return d

    def write(name, family, shape, data):
        (root / name).write_bytes(data)
        files[name] = (family, shape)

    # DNG, 16-bit strips: per-site black levels, neutral, matrix, active area
    m = raw_mosaic(rng, h, w, 500, 15800, 0)
    rows = 250
    blobs = [m[y:y + rows].astype("<u2").tobytes() for y in range(0, h, rows)]
    aa = (12, 16, h - 12, w - 16)
    extra = {50713: (3, [2, 2]), 50714: (3, [512, 520, 516, 508]), 50717: (3, [16000]),
             50728: (5, [(47, 100), (1, 1), (63, 100)]), 50721: (10, cm),
             50829: (3, list(aa))}
    ifds = [(_dng_entries(h, w, (0, 1, 1, 2), extra, range(len(blobs)),
                          rows_per_strip=rows), None)]
    write("strips.dng", "dng", (aa[2] - aa[0], aa[3] - aa[1]),
          tiff_bytes(_with_counts(ifds, blobs), blobs))

    # DNG, deflate tiles with predictor 2
    m = raw_mosaic(rng, h, w, 256, 16383, 1)
    blobs = [zlib.compress(predict2(t).astype("<u2").tobytes(), 1) for t in tiles_of(m)]
    extra = {50714: (3, [256]), 50717: (3, [16383]), 317: (3, [2]),
             50728: (5, [(52, 100), (1, 1), (71, 100)])}
    ifds = [(_dng_entries(h, w, (1, 0, 2, 1), extra, range(len(blobs)), tile=tile,
                          compression=8), None)]
    write("deflate.dng", "dng", (h, w), tiff_bytes(_with_counts(ifds, blobs), blobs))

    # DNG, lossless-JPEG tiles (two components a row, as DNG writers emit)
    m = raw_mosaic(rng, h, w, 0, 65535, 2)
    blobs = [ljpeg_bytes(t.reshape(tile, tile // 2, 2), 16) for t in tiles_of(m)]
    extra = {50714: (3, [1024]), 50717: (3, [65535]), 50721: (10, cm),
             50728: (5, [(45, 100), (1, 1), (58, 100)])}
    ifds = [(_dng_entries(h, w, (2, 1, 1, 0), extra, range(len(blobs)), tile=tile,
                          compression=7), None)]
    write("ljpeg.dng", "dng", (h, w), tiff_bytes(_with_counts(ifds, blobs), blobs))

    # DNG, LZW strips with predictor 2
    m = raw_mosaic(rng, h, w, 128, 4095, 3)
    rows = 500
    blobs = [_lzw_encode(predict2(m[y:y + rows]).astype("<u2").tobytes())
             for y in range(0, h, rows)]
    extra = {50714: (3, [128]), 50717: (3, [4095]), 317: (3, [2]),
             50728: (5, [(49, 100), (1, 1), (66, 100)])}
    ifds = [(_dng_entries(h, w, (0, 1, 1, 2), extra, range(len(blobs)), compression=5,
                          rows_per_strip=rows), None)]
    write("lzw.dng", "dng", (h, w), tiff_bytes(_with_counts(ifds, blobs), blobs))

    # CR2: one 14-bit stream in Canon's slices, the masked border black
    m = raw_mosaic(rng, h, w, 2048, 16000, 4)
    left, top = max(8, w // 96 & ~1), max(4, h // 100 & ~1)  # the masked borders
    m[:, :left] = rng.normal(2048.0, 4.0, (h, left)).astype(np.uint16)
    m[:top] = rng.normal(2048.0, 4.0, (top, w)).astype(np.uint16)
    n, wa = 2, w // 3
    widths = [wa] * n + [w - n * wa]
    cols = np.cumsum([0] + widths)
    stream = np.concatenate([m[:, a:b].reshape(-1) for a, b in zip(cols[:-1], cols[1:])])
    lj = ljpeg_bytes(stream.reshape(h, w // 2, 2), 14)
    colordata = [0] * 1273
    colordata[63:67] = [2100, 1024, 1024, 1500]
    sensor = [17, w, h, 0, 0, left, top, w - 1, h - 1] + [0] * 8
    ifds = [({271: (2, "Canon"), 34665: (4, [("ifd", 1)])}, 3),
            ({37500: (7, ("ifd", 2))}, None),
            ({0x00E0: (3, sensor), 0x4001: (3, colordata)}, None),
            ({256: (4, [w]), 257: (4, [h]), 259: (3, [6]), 273: (4, [("blob", 0)]),
              279: (4, [len(lj)]), 0xC640: (3, [n, wa, w - n * wa])}, None)]
    write("canon.cr2", "cr2", (h - top, w - left),
          tiff_bytes(ifds, [lj], extra=b"CR\x02\x00"))

    # NEF: 14-bit packed, GRBG, the as-shot balance in a Nikon MakerNote
    m = raw_mosaic(rng, h, w, 0, 16383, 5)
    packed = _pack_msb(m, 14)
    mn = b"Nikon\x00\x02\x10\x00\x00" + tiff_bytes(
        [({0x000C: (5, [(195, 100), (142, 100), (1, 1), (1, 1)])}, None)])
    ifds = [({254: (4, [1]), 271: (2, "NIKON CORPORATION"), 330: (4, [("ifd", 1)]),
              34665: (4, [("ifd", 2)])}, None),
            ({254: (4, [0]), 256: (4, [w]), 257: (4, [h]), 258: (3, [14]), 259: (3, [1]),
              262: (3, [32803]), 273: (4, [("blob", 0)]), 277: (3, [1]),
              279: (4, [len(packed)]), 33421: (3, [2, 2]), 33422: (1, [1, 0, 2, 1])}, None),
            ({37500: (7, ("blob", 1))}, None)]
    write("nikon.nef", "nef", (h, w), tiff_bytes(ifds, [packed, mn]))

    # ARW: 16-bit strips, TIFF/EP levels and AsShotNeutral
    m = raw_mosaic(rng, h, w, 512, 16383, 6)
    payload = m.astype("<u2").tobytes()
    ifds = [({254: (4, [1]), 271: (2, "SONY"), 330: (4, [("ifd", 1)])}, None),
            ({254: (4, [0]), 256: (4, [w]), 257: (4, [h]), 258: (3, [16]), 259: (3, [1]),
              262: (3, [32803]), 273: (4, [("blob", 0)]), 277: (3, [1]),
              279: (4, [len(payload)]), 33421: (3, [2, 2]), 33422: (1, [0, 1, 1, 2]),
              50714: (3, [512]), 50717: (3, [16383]),
              50728: (5, [(48, 100), (1, 1), (69, 100)])}, None)]
    write("sony.arw", "arw", (h, w), tiff_bytes(ifds, [payload]))

    # RW2: magic 85, borders, per-colour blacks, balances x256
    m = raw_mosaic(rng, h, w, 128, 4095, 7)
    top, left, bottom, right = 8, 16, h - 8, w - 16
    ifds = [({0x0002: (3, [w]), 0x0003: (3, [h]), 0x0004: (3, [top]), 0x0005: (3, [left]),
              0x0006: (3, [bottom]), 0x0007: (3, [right]), 0x0009: (3, [2]),
              0x000A: (3, [12]), 0x0011: (3, [497]), 0x0012: (3, [371]),
              0x001C: (3, [128]), 0x001D: (3, [130]), 0x001E: (3, [127]),
              0x0118: (4, [("blob", 0)])}, None)]
    write("panasonic.rw2", "rw2", (bottom - top, right - left),
          tiff_bytes(ifds, [m.astype("<u2").tobytes()], magic=85))
    return files


# the develop stage of each family (io/raw.py's _develop_*), by the file's
# family name: (blob, device, timer) -> (linear RGB on the host, matrix)
def _raw_developers():
    from paintfe_tpu_torch.io import raw

    return {"dng": raw._develop_dng, "cr2": raw._develop_cr2, "nef": raw._develop_nef,
            "arw": lambda blob, dev, timer=None: raw._develop_tiffep_cfa(blob, "arw", dev, timer),
            "rw2": raw._develop_rw2}


RAW_STAGES = ("decode", "upload", "develop", "download", "matrix", "srgb", "u8")
# the RAW phase's CLI runs: (files, script, extra arguments, output directory).
# Each file goes through the serial headline run once, half of them to JPEG
# and half to TIFF; the spatial script runs under --shard on the NEF and on
# the first 1920x1080 --animate frame (a DNG): two shape buckets.  Each run
# is repeated with --device cpu, where the plain median takes most of a
# minute a 24 MP frame, so the --shard run holds one 24 MP file.
RAW_RUNS = {
    "serial jpeg": (("strips.dng", "ljpeg.dng", "canon.cr2", "panasonic.rw2"), "headline",
                    ["-f", "jpeg"], "jpeg"),
    "serial tiff": (("deflate.dng", "lzw.dng", "nikon.nef", "sony.arw"), "headline",
                    ["-f", "tiff"], "tiff"),
    "shard spatial": (("nikon.nef", "gif0.dng"), "spatial", ["-f", "jpeg", "--shard"], "shard"),
}
RAW_GIF = ("gif0.dng", "gif1.nef", "gif2.arw", "gif3.dng")


def raw_launches(files, runs=RAW_RUNS):
    """K-blur, K-median and K-warp launches each run of `runs` must make on
    the card: serially one K-blur an image (the headline script); under
    --shard one of each kernel a shape bucket of the inputs (the spatial
    script), the buckets being the decoded sizes (`files` maps a name to
    its family and output shape)."""
    out = {}
    for tag, (names, _, extra, _) in runs.items():
        if "--shard" in extra:
            n = len({files[name][1] for name in names})
            out[tag] = {"gaussian_blur_fused": n, "median_kernel": n, "gather_bilinear_u8": n}
        else:
            out[tag] = {"gaussian_blur_fused": len(names), "median_kernel": 0,
                        "gather_bilinear_u8": 0}
    return out


def raw_gif_files(root, h, w, seed=52):
    """Four h x w RAW frames of the full sensor size (no crop), for
    --animate: two DNGs (16-bit strips), a NEF and an ARW, each a scene of
    its own; a name -> (family, output shape) map as raw_files gives."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for k, name in enumerate(RAW_GIF):
        m = raw_mosaic(rng, h, w, 0, 16383, 10 + k)
        if name.endswith(".dng"):
            blob = m.astype("<u2").tobytes()
            ifds = [(_dng_entries(h, w, (0, 1, 1, 2), {50717: (3, [16383])}, [0]), None)]
            data = tiff_bytes(_with_counts(ifds, [blob]), [blob])
        else:
            payload = m.astype("<u2").tobytes()
            ifds = [({254: (4, [1]), 330: (4, [("ifd", 1)])}, None),
                    ({254: (4, [0]), 256: (4, [w]), 257: (4, [h]), 258: (3, [16]),
                      259: (3, [1]), 262: (3, [32803]), 273: (4, [("blob", 0)]),
                      277: (3, [1]), 279: (4, [len(payload)]), 33421: (3, [2, 2]),
                      33422: (1, [1, 0, 2, 1]), 50717: (3, [16383])}, None)]
            data = tiff_bytes(ifds, [payload])
        (root / name).write_bytes(data)
    return {name: (name[-3:], (h, w)) for name in RAW_GIF}


def drive_raw_path(dev, tmp, card):
    """The RAW phase at RAW_SIZE (24 MP): raw_files' eight camera files,
    each family's develop stage held against the CPU's and timed by
    sub-stage; the native LZW decode against the pure one on 1 MiB; the
    CLI runs of RAW_RUNS and a GIF of four 1920x1080 RAW frames on the card,
    each also run with --device cpu in the background, every output file
    byte-equal to that run's, and K-blur, K-median and K-warp launching
    exactly raw_launches' counts (four K-blur launches for the GIF)."""
    from PIL import Image

    from paintfe_tpu_torch import cli
    from paintfe_tpu_torch.io import deep_export
    from paintfe_tpu_torch.io.codecs import load_frames

    started = time.perf_counter()
    root = tmp / "raw"
    (root / "in").mkdir(parents=True)
    (root / "gif").mkdir()
    (root / "headline.rhai").write_text(HEADLINE)
    (root / "spatial.rhai").write_text(SPATIAL)
    h, w = RAW_SIZE
    files = raw_files(root / "in", h, w)
    frames = raw_gif_files(root / "gif", *FHD)
    print(f"  raw: wrote {len(files)} camera files at {w}x{h} and {len(RAW_GIF)} at "
          f"{FHD[1]}x{FHD[0]} ({time.perf_counter() - started:.3f} s)")

    def argv(names, script, extra, out, device):
        return ["-i", *(str(root / ("gif" if n in frames else "in") / n) for n in names),
                "-s", str(root / f"{script}.rhai"), *extra, "--output-dir",
                str(root / f"{device}_{out}"), "--device", device]

    def gif_argv(device):
        return ["-i", *(str(root / "gif" / n) for n in RAW_GIF), "-s", str(root / "headline.rhai"),
                "--animate", str(root / f"{device}.gif"), "--fps", "8", "--device", device]

    # the --device cpu twins in the background, three at a time, the
    # longest (the plain median of the --shard run) first
    cpu_runs = sorted(RAW_RUNS.items(), key=lambda kv: "--shard" not in kv[1][2])
    cpu = _background_cli([(f"raw {tag}", argv(*spec, "cpu")) for tag, spec in cpu_runs]
                          + [("raw gif", gif_argv("cpu"))], workers=3)
    try:
        _raw_develop_checks(dev, root, files, card)
        blob = (root / "in" / "sony.arw").read_bytes()[-(1 << 20):]
        enc = deep_export._lzw_encode(blob)
        t0 = time.perf_counter()
        native = deep_export._lzw_decode(enc, len(blob))
        t1 = time.perf_counter()
        plain = deep_export._lzw_decode_plain(enc, len(blob))
        t2 = time.perf_counter()
        if not native == plain == blob:
            raise CheckFailed("raw: the native LZW decode differs from the pure one on 1 MiB")
        print(f"  ok  raw: the native LZW decode equals the pure one on 1 MiB ({len(enc)} bytes "
              f"coded): {(t1 - t0) * 1e3:.1f} ms native, {(t2 - t1) * 1e3:.1f} ms pure Python")

        shapes = {**files, **frames}
        expected = raw_launches(shapes)
        for tag, (names, script, extra, out) in RAW_RUNS.items():
            c0 = _counts()
            t0 = time.perf_counter()
            rc = cli.main(argv(names, script, extra, out, "cuda"))
            seconds = time.perf_counter() - t0
            c1 = _counts()
            got = {name: c1[name] - c0[name] for name in expected[tag]}
            print(f"  raw {tag}: rc {rc} ({seconds:.3f} s on the card, {len(names)} files); "
                  f"launches {got}")
            if rc != 0:
                raise CheckFailed(f"raw {tag}: CLI exit code {rc}")
            if got != expected[tag]:
                raise CheckFailed(f"raw {tag}: launches {got}, expected {expected[tag]}")
            for name in names:
                ext = {"jpeg": "jpg"}.get(extra[1], extra[1])
                with Image.open(root / f"cuda_{out}" / f"{pathlib.Path(name).stem}.{ext}") as im:
                    if (im.height, im.width) != shapes[name][1]:
                        raise CheckFailed(f"raw {tag}: {name} came out {im.width}x{im.height}, "
                                          f"expected {shapes[name][1][1]}x{shapes[name][1][0]}")
        c0 = _counts()
        t0 = time.perf_counter()
        rc = cli.main(gif_argv("cuda"))
        seconds = time.perf_counter() - t0
        launches = _counts()["gaussian_blur_fused"] - c0["gaussian_blur_fused"]
        print(f"  raw --animate GIF: rc {rc} ({seconds:.3f} s on the card, {len(RAW_GIF)} RAW "
              f"frames at {FHD[1]}x{FHD[0]}, NeuQuant in C++); K-blur {launches} launches")
        if rc != 0 or launches != len(RAW_GIF) or len(load_frames(root / "cuda.gif")[0]) != 4:
            raise CheckFailed(f"raw --animate GIF: rc {rc}, K-blur {launches} launches, "
                              f"expected 0 and {len(RAW_GIF)}, four frames")
    finally:
        cpu_results = [f.result() for f in cpu]
    for ((tag, (_, _, _, out)), (rc_cpu, seconds)) in zip(cpu_runs, cpu_results):
        if rc_cpu != 0:
            raise CheckFailed(f"raw {tag}: the --device cpu run's exit code {rc_cpu}")
        names = _same_files(f"raw {tag}", root / f"cuda_{out}", root / f"cpu_{out}")
        print(f"  ok  raw {tag}: {len(names)} files equal the --device cpu run's bytes (that "
              f"run {seconds:.3f} s, beside the card's)")
    rc_cpu, seconds = cpu_results[-1]
    if rc_cpu != 0 or (root / "cuda.gif").read_bytes() != (root / "cpu.gif").read_bytes():
        raise CheckFailed(f"raw --animate GIF differs from the --device cpu run's (rc {rc_cpu})")
    print(f"  ok  raw --animate GIF equals the --device cpu run's bytes (that run {seconds:.3f} s)")
    print(f"  raw phase: {time.perf_counter() - started:.1f} s wall [card: {card}]")


def _raw_develop_checks(dev, root, files, card):
    """Each RAW file's load on the card, timed by sub-stage (RAW_STAGES)
    with the card's busy time over the load, its develop stage (linear RGB)
    held against the same function on the CPU and its RGBA against the
    CPU's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paintfe_tpu_torch.io import raw
    from paintfe_tpu_torch.utils.profiling import StageTimer

    developers = _raw_developers()
    # warm-up: the first develop on the card loads torch's kernels
    developers["dng"]((root / "gif" / RAW_GIF[0]).read_bytes(), dev)
    print(f"raw loads, {RAW_SIZE[1]}x{RAW_SIZE[0]} each, wall ms by stage [card: {card}]:")
    for name, (family, shape) in files.items():
        blob = (root / "in" / name).read_bytes()
        develop = developers[family]
        timer = StageTimer(dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rgb, cm = develop(blob, dev, timer)
            rgba = raw._finish_raw(rgb, cm, timer)
            wall = (time.perf_counter() - t0) * 1e3
        busy = _device_us(prof)[0] / 1e3
        want_rgb, want_cm = develop(blob, "cpu")
        if rgb.shape != want_rgb.shape or not np.array_equal(rgb, want_rgb):
            raise CheckFailed(f"raw {name}: the card's develop stage differs from the CPU's")
        if not np.array_equal(rgba, raw._finish_raw(want_rgb, want_cm)) or rgba.shape[:2] != shape:
            raise CheckFailed(f"raw {name}: the card's RGBA differs from the CPU's, or its shape "
                              f"{rgba.shape[:2]} from {shape}")
        ms = dict.fromkeys(RAW_STAGES, 0.0)
        for stage, seconds in timer.stages:
            ms[stage] += seconds * 1e3
        print(f"  {name} ({family}, {shape[1]}x{shape[0]}): load {wall:.1f} ms = "
              + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
              + f"; card busy {busy:.2f} ms ({busy / wall * 100:.2f}% of the load)")
    print("  ok  raw: every family's develop stage on the card equals the CPU's (linear RGB "
          "and RGBA, tolerance 0)")


def check_streams(dev, rounds=20):
    """Two execute_script_async workers at once, each under its own CUDA
    stream, blurring at different sigmas around a twist, for `rounds`
    rounds at 1920x1080: every result must equal the same script through
    the plain versions on the card (K-blur's constant taps are rewritten
    between launches on both streams)."""
    import numpy as np
    import torch

    from paintfe_tpu_torch.scripting import execute_script_async, execute_script_sync

    scripts = ("apply_blur(1.0); apply_twist(30.0); apply_blur(4.0);",
               "apply_blur(6.0); apply_twist(-45.0); apply_blur(0.5);")
    h, w = FHD
    img = np.random.default_rng(17).integers(0, 256, (h, w, 4), np.uint8)
    with _plain_kernels():
        want = [execute_script_sync(s, img, w, h, device=dev)[0] for s in scripts]
    streams = [torch.cuda.Stream(dev) for _ in scripts]
    c0 = _counts()
    t0 = time.perf_counter()
    for k in range(rounds):
        runs = [execute_script_async(s, img, w, h, device=dev, stream=st)
                for s, st in zip(scripts, streams)]
        for (thread, q), expected, s in zip(runs, want, scripts):
            thread.join(300)
            msgs = []
            while not q.empty():
                msgs.append(q.get())
            if not msgs or msgs[-1].kind != "completed":
                raise CheckFailed(f"streams: round {k}: the worker of {s!r} ended with "
                                  f"{msgs[-1].payload if msgs else 'no message'}")
            if not np.array_equal(msgs[-1].payload[0], expected):
                raise CheckFailed(f"streams: round {k}: the worker of {s!r} on its own "
                                  "stream differs from the plain versions")
    c1 = _counts()
    blurs = c1["gaussian_blur_fused"] - c0["gaussian_blur_fused"]
    if blurs != 4 * rounds:
        raise CheckFailed(f"streams: {blurs} K-blur launches, expected {4 * rounds}")
    print(f"  ok  streams: two async workers on two CUDA streams, {rounds} rounds at "
          f"1920x1080 ({time.perf_counter() - t0:.3f} s, {blurs} K-blur launches), every "
          "result equals the plain versions")


def check_effects(dev, gen):
    """Each effect op of EFFECT_OPS at 1920x1080, resize (all four filters)
    and resize_canvas through a script context, and each op of the menu
    path (menu_op_table) under an elliptic selection, on the card:
    byte-equal to the same op on the CPU (ROADMAP C2: transcendentals come
    from host tables and fields, so the devices agree)."""
    import numpy as np
    import torch

    from paintfe_tpu_torch.parallel.pipeline import _OP_TABLE
    from paintfe_tpu_torch.scripting.engine import execute_script_sync

    print("effect ops at 1920x1080, the card against the CPU (byte-equal):")
    img = _rand(gen, FHD, dev)
    host = img.cpu()
    for name, args in EFFECT_OPS:
        got = _OP_TABLE[name](img, *args).cpu()
        want = _OP_TABLE[name](host, *args)
        if not got.equal(want):
            raise CheckFailed(f"{name}{args}: the card's bytes differ from the CPU's "
                              f"({int((got != want).sum())} bytes)")
    h, w = FHD
    arr = host.numpy()
    for filt in ("nearest", "bilinear", "bicubic", "lanczos3"):
        src = (f'resize_image(1280, 720, "{filt}"); resize_image(2400, 1350, "{filt}"); '
               'resize_canvas(2000, 1200, "center");')
        got = execute_script_sync(src, arr, w, h, None, rng_seed=1, device=dev)
        want = execute_script_sync(src, arr, w, h, None, rng_seed=1, device="cpu")
        if got[1:3] != want[1:3] or not np.array_equal(got[0], want[0]):
            raise CheckFailed(f"resize {filt}: the card's result differs from the CPU's")
    print(f"  ok  {len(EFFECT_OPS)} effect ops, resize (4 filters, down and up) and "
          "resize_canvas")
    mask_host = _ellipse(h, w)
    mask = torch.from_numpy(mask_host).to(dev)
    table = menu_op_table(h, w)
    for name, fn in table:
        got = fn(img, mask).cpu()
        want = fn(host, torch.from_numpy(mask_host))
        if not got.equal(want):
            raise CheckFailed(f"menu op {name}: the card's result differs from the CPU's "
                              f"({int((got != want).sum())} of {want.numel()} entries)")
    print(f"  ok  {len(table)} menu ops under an elliptic selection (the adjustments, "
          "effects, the Liquify and mesh warps, the gradients)")


def time_effects(dev, gen, card):
    """Each effect op of EFFECT_OPS, then each op of the menu path
    (menu_op_table), on one 3840x2160 frame on the card: CUDA
    events around one call, median of 7 after warm-up (host work inside the
    call, its host-built fields' uploads among it, included)."""
    from paintfe_tpu_torch.parallel.pipeline import _OP_TABLE

    import torch

    img = _rand(gen, UHD, dev)
    print(f"effect ops at 3840x2160, one call, median of 7 [card: {card}]:")
    for name, args in EFFECT_OPS:
        ms = _time_ms(lambda op=_OP_TABLE[name], args=args: op(img, *args), runs=7)
        print(f"  {name}{args}: {ms:.4f} ms [card: {card}]")
    mask = torch.from_numpy(_ellipse(*UHD)).to(dev)
    print(f"menu ops at 3840x2160 under an elliptic selection, one call, median of 7 "
          f"[card: {card}]:")
    for name, fn in menu_op_table(*UHD):
        ms = _time_ms(lambda fn=fn: fn(img, mask), runs=7)
        print(f"  {name}: {ms:.4f} ms [card: {card}]")


def _wall_ms(fn, runs=5):
    """The median wall time of fn() ending in a device synchronise, in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_flatten(dev, seed=5):
    """The wall time of Canvas.composite on one 3840x2160 six-layer
    document (_layered_document), median of 5, in ms."""
    import numpy as np

    doc = _layered_document(np.random.default_rng(seed), *UHD)
    return _wall_ms(lambda: doc.composite(device=dev))


def profile_flatten(dev, doc):
    """Where the flatten of one document goes: the wall time of
    Canvas.composite, parts of it timed alone (the active-tile mask built on
    the card from resident layers, beside the host definition it replaced;
    the uploads of the visible raster layers) and, from torch.profiler, the
    device's busy time and K-composite's share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paintfe_tpu_torch.core.canvas import active_tile_mask_device, upload

    vis = doc.visible_layers()
    rasters = [l for _, l in vis if l.content != "adjustment"]
    resident = [upload(l.pixels, dev) for l in rasters]
    flatten_ms = _wall_ms(lambda: doc.composite(device=dev))
    mask_ms = _wall_ms(lambda: active_tile_mask_device([t[..., 3] for t in resident],
                                                       doc.height, doc.width))
    host_mask_ms = _wall_ms(lambda: doc.active_tile_mask(vis))
    upload_ms = _wall_ms(lambda: [upload(l.pixels, dev) for l in rasters])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        doc.composite(device=dev)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    busy, kernel, _ = _device_us(prof, "composite_kernel")
    device = (f"in one traced flatten of {traced_ms:.3f} ms wall, device busy "
              f"{busy / 1e3:.3f} ms ({busy / 1e3 / traced_ms * 100:.1f}% of it, copies "
              f"included), K-composite {kernel / 1e3:.3f} ms" if busy
              else "device busy not measured (the profiler saw no device time)")
    print(f"  flatten of one {doc.width}x{doc.height} document, median of 5: "
          f"{flatten_ms:.3f} ms wall; alone: active-tile mask on the card {mask_ms:.3f} ms "
          f"(the host definition: {host_mask_ms:.3f} ms), {len(rasters)} layer uploads "
          f"{upload_ms:.3f} ms; {device}")


def _device_us(prof, name=""):
    """Device time in a torch.profiler trace, in us: every kernel's, copy's
    and fill's, and those whose name holds `name`; and how many there were
    (launches, copies and fills).  A sum over the trace's raw kineto events
    (parsing them into key_averages' rows takes about 80 us an event:
    minutes over a brush stroke's 10^5 launches)."""
    import torch

    busy = named = 0.0
    ops = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us = e.duration_ns() / 1e3
        busy += us
        ops += 1
        if name and name in e.name():
            named += us
    return busy, named, ops


def _time_ms(fn, runs=TIMED_RUNS):
    """One call's time in ms: the median of `runs` samples after three
    calls of warm-up (one, and LONG_RUNS samples, where that call took over
    LONG_CALL_MS), each a pair of CUDA events around one call (so the
    host's time from the first event to the launch counts)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) * 1e3 > LONG_CALL_MS:
        runs = min(runs, LONG_RUNS)
    else:
        fn()
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _queued_ms(fn, one_ms, runs=TIMED_RUNS):
    """One call's device time when calls queue back to back, in ms: the
    median of `runs` samples, each CUDA events around n calls divided by n,
    n such that they take about 2 ms (at most 20), so that the host's time
    before a launch overlaps the calls ahead of it.  A printed figure
    beside _time_ms's, labelled "queued"; `one_ms` (_time_ms's) comes back
    unmeasured where one call takes over 1 ms."""
    import torch

    n = min(20, int(2.0 / one_ms))
    if n < 2:
        return one_ms
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _peak_mb(fn):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def _bound(nbytes, ops, ops_per_s):
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _chain_ops(ov, nt, px):
    """f32 operations of K-chain on this overlay: the blur's two passes of
    nt multiplies and adds on 4 channels, then the tail: 36 operations a
    pixel, 55 more where the overlay is not clear (its soft-light
    Porter-Duff)."""
    return 4 * nt * 4 * px + 36 * px + 55 * int((ov[..., 3] != 0).sum())


def _composite_ops(layers, modes, opacities, conceal=None):
    """f32 operations of K-composite on these layers: a blend that runs (top
    alpha, after the conceal mask, not 0, and not NORMAL-opaque at full
    opacity) takes 8 u8 -> f32 conversions, the opacity product, 7 for the
    alpha, 8 a channel for the Porter-Duff tail, and its mixer's operations
    (MIXER_OPS) a channel."""
    ops = 0
    for k, (layer, mode, o) in enumerate(zip(layers, modes, opacities)):
        alpha = layer[..., 3]
        if conceal is not None:
            alpha = (alpha.int() * (255 - conceal[k].int()) // 255)
        runs = alpha != 0
        if mode == 0 and o >= 1.0:
            runs &= alpha != 255
        ops += int(runs.sum()) * (16 + 24 + 3 * MIXER_OPS[mode])
    return ops


def time_cases(dev, gen, card):
    """K-median at MEDIAN_RADII, K-blur at BLUR_SIGMAS on one 3840x2160
    frame and on a batch of BATCH, K-chain at sigma 2, K-composite at
    COMPOSITE_DEPTHS with and without conceal masks, on its fast path and
    on divide-heavy modes, K-pass at PASS_SIGMAS along both axes, and
    K-warp (_warp_cases), each the median of TIMED_RUNS CUDA-event timings
    of one call beside its bound, and its queued device time (_queued_ms).
    Prints one line a case and returns them as dicts."""
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import (composite_stack_kernel, gaussian_blur_fused,
                                               gaussian_blur_pass, median_kernel,
                                               median_route)

    h, w = UHD
    px = h * w
    frame = px * 4
    img = _rand(gen, UHD, dev)
    batch = _rand(gen, (BATCH,) + UHD, dev)
    ov = _overlay(gen, UHD, dev)
    cases = []
    for r in MEDIAN_RADII:
        # a selection reads each of the (2r+1)^2 window values of each channel
        cases.append((f"K-median r={r} ({median_route(r)} route) 3840x2160",
                      lambda r=r: median_kernel(img, r),
                      _bound(2 * frame, (2 * r + 1) ** 2 * 4 * px, PACKED_BYTE_OPS_PER_S)))
    for sigma in BLUR_SIGMAS:
        nt = len(gaussian_kernel(sigma))
        for x, n, shape in ((img, 1, "3840x2160"), (batch, BATCH, f"[{BATCH},2160,3840,4]")):
            cases.append((f"K-blur sigma={sigma} {shape}",
                          lambda x=x, sigma=sigma: gaussian_blur_fused(x, sigma),
                          _bound(2 * frame * n, 4 * nt * 4 * px * n, F32_OPS_PER_S)))
    cases.append(("K-chain sigma=2.0 3840x2160", lambda: fused_chain_kernel(img, ov),
                  _bound(3 * frame, _chain_ops(ov, len(gaussian_kernel(2.0)), px),
                         F32_OPS_PER_S)))
    # K-composite: stacks of N layers over an initial accumulator, cycling
    # the timed modes, with and without a conceal mask on every layer; then
    # four NORMAL layers of alpha 255 at full opacity (the fast path), and
    # four layers of divide-heavy modes
    deep = max(COMPOSITE_DEPTHS)
    layers = [_rand(gen, UHD, dev) for _ in range(deep)]
    masks = [_rand(gen, UHD, dev)[..., 0].contiguous() for _ in range(deep)]
    init = _rand(gen, UHD, dev)
    for n in COMPOSITE_DEPTHS:
        modes = [TIMED_MODES[k % 4] for k in range(n)]
        opac = [TIMED_OPACITIES[k % 4] for k in range(n)]
        for name, conceal in (("", None), (" +conceal", masks[:n])):
            nbytes = (n + 2) * frame + (n * px if conceal else 0)
            cases.append((f"K-composite N={n}{name} +init 3840x2160",
                          lambda n=n, modes=modes, opac=opac, conceal=conceal:
                          composite_stack_kernel(layers[:n], modes, opac, conceal, init),
                          _bound(nbytes, _composite_ops(layers[:n], modes, opac, conceal),
                                 F32_OPS_PER_S)))
    # the timed stack again with one layer 4 bytes off a 16-byte boundary:
    # the entry's scalar path
    shifted = layers[:3] + [_offset_copy(layers[3], 4)]
    cases.append(("K-composite N=4 +init, one layer 4 bytes off (scalar path) 3840x2160",
                  lambda: composite_stack_kernel(shifted, TIMED_MODES, TIMED_OPACITIES, None,
                                                 init),
                  _bound(6 * frame, _composite_ops(shifted, TIMED_MODES, TIMED_OPACITIES),
                         F32_OPS_PER_S)))
    opaque = [t.clone() for t in layers[:4]]
    for t in opaque:
        t[..., 3] = 255
    cases.append(("K-composite N=4 NORMAL, alpha 255, opacity 1 (fast path) +init 3840x2160",
                  lambda: composite_stack_kernel(opaque, (0,) * 4, (1.0,) * 4, None, init),
                  _bound(6 * frame, _composite_ops(opaque, (0,) * 4, (1.0,) * 4),
                         F32_OPS_PER_S)))
    heavy = (7, 21, 19, 16)  # COLOR_DODGE, VIVID_LIGHT, DIVIDE, SOFT_LIGHT
    cases.append(("K-composite N=4 divide-heavy modes +init 3840x2160",
                  lambda: composite_stack_kernel(layers[:4], heavy, TIMED_OPACITIES, None, init),
                  _bound(6 * frame, _composite_ops(layers[:4], heavy, TIMED_OPACITIES),
                         F32_OPS_PER_S)))
    # K-pass: one pass along W = 3840 and along W = 2160 (the second pass of
    # gaussian_blur_pallas, on the transposed planes)
    planar = img.permute(2, 0, 1).float().contiguous()
    turned = planar.transpose(1, 2).contiguous()
    for sigma in PASS_SIGMAS:
        taps = gaussian_kernel(sigma)
        for x in (planar, turned):
            cases.append((f"K-pass sigma={sigma} one pass f32 {list(x.shape)}",
                          lambda x=x, taps=taps: gaussian_blur_pass(x, taps),
                          _bound(2 * 4 * 4 * px, 2 * len(taps) * 4 * px, F32_OPS_PER_S)))
    library, extra = _warp_cases(gen, dev, img, batch, cases)
    print(f"timed cases, CUDA events, median of {TIMED_RUNS} (of {LONG_RUNS} for a call "
          f"over {LONG_CALL_MS:.0f} ms) [card: {card}]:")
    result = []
    for name, fn, (bound_ms, bound_by) in cases:
        ms = _time_ms(fn)
        queued = _queued_ms(fn, ms)
        row = {"case": name, "ms": ms, "queued_ms": queued, "bound_ms": bound_ms,
               "bound_by": bound_by, **extra.get(name, {})}
        note = "".join(f", {k} {v:.3f}" for k, v in extra.get(name, {}).items())
        if name in library:
            row["library_ms"] = _time_ms(library[name])
            note += f", F.grid_sample f32 {row['library_ms']:.4f} ms"
        result.append(row)
        print(f"  {name}: {ms:.4f} ms (queued {queued:.4f} ms), bound {bound_ms:.4f} ms "
              f"by {bound_by} ({bound_ms / ms * 100:.1f}% of it){note} [card: {card}]")
    return result


def _l2_sector_mb(sx, sy, hs, ws, images):
    """The L2 traffic of K-warp's taps in MB, if each pixel's taps cost the
    distinct 32-byte sectors they touch (two rows, one or two sectors a
    row), for `images` images sharing the field."""
    import torch

    x0 = torch.floor(sx).clamp(-1, ws).long()
    y0 = torch.floor(sy).clamp(-1, hs).long()
    s0 = x0.clamp(0, ws - 1) // 8
    s1 = (x0 + 1).clamp(0, ws - 1) // 8
    rows = 1 + (y0.clamp(0, hs - 1) != (y0 + 1).clamp(0, hs - 1)).long()
    return float((rows * (1 + (s0 != s1).long())).sum()) * 32 * images / 1e6


def _warp_cases(gen, dev, img, batch, cases):
    """K-warp's timed cases, appended to `cases`: both modes on the bulge
    0.5 field and on the random field that reaches outside the source, one
    3840x2160 frame and a batch of BATCH, and the document path's rotation
    batch.  Returns each case's yardstick
    (F.grid_sample, f32, border, align_corners: clamp mode's function) and,
    for the random field, the taps' L2 sector traffic: its taps land
    anywhere in the 33 MB source, which L2 (50 MB) holds, so its bound stays
    the device memory one and the sectors say what it moves instead."""
    import torch
    import torch.nn.functional as F

    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    h, w = UHD
    px = h * w
    frame = px * 4
    fields = _warp_fields(gen, h, w, dev)
    frames = [(x, n, shape, (x[None] if n == 1 else x).permute(0, 3, 1, 2).float().contiguous())
              for x, n, shape in ((img, 1, "3840x2160"), (batch, BATCH, f"[{BATCH},2160,3840,4]"))]
    library, extra = {}, {}
    for field in ("bulge 0.5", "random, out of source"):
        sx, sy = fields[field]
        grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], -1)[None]
        for x, n, shape, planar in frames:
            grid_n = grid.expand(n, -1, -1, -1).contiguous()
            for mode in ("clamp", "zero"):
                name = f"K-warp {mode} {field} field {shape}"
                # the source, the two f32 fields (shared) and the output once;
                # 12 f32 operations a channel, 4 a pixel for the fractions
                cases.append((name, lambda x=x, sx=sx, sy=sy, mode=mode:
                              gather_bilinear_u8(x, sx, sy, mode),
                              _bound(2 * frame * n + 8 * px, 52 * px * n, F32_OPS_PER_S)))
                library[name] = (lambda planar=planar, grid_n=grid_n: F.grid_sample(
                    planar, grid_n, mode="bilinear", padding_mode="border", align_corners=True))
                if field.startswith("random"):
                    extra[name] = {"l2_sector_mb": _l2_sector_mb(sx, sy, h, w, n)}
    # the document path's bilinear rotation: the six layers and one mask of
    # a portrait canvas (3840x2160 after its 90-degree turn) in one batch;
    # yardstick: F.grid_sample with zero padding
    from paintfe_tpu_torch.ops.transform import _affine_map, _affine_params

    n, rh, rw = 7, w, h
    rot = torch.randint(0, 256, (n, rh, rw, 4), generator=gen, dtype=torch.uint8).to(dev)
    rx, ry, _ = _affine_map(_affine_params(17.5, 0.0, 0.0, 1.0, 0.0, 0.0, rw, rh), rw, rh, dev)
    name = f"K-warp zero, 17.5-degree rotation field [{n},{rh},{rw},4]"
    cases.append((name, lambda: gather_bilinear_u8(rot, rx, ry, "zero"),
                  _bound(2 * frame * n + 8 * px, 52 * px * n, F32_OPS_PER_S)))
    rot_planar = rot.permute(0, 3, 1, 2).float().contiguous()
    rot_grid = torch.stack([rx / (rw - 1) * 2 - 1, ry / (rh - 1) * 2 - 1], -1)[None]
    rot_grid = rot_grid.expand(n, -1, -1, -1).contiguous()
    library[name] = lambda: F.grid_sample(rot_planar, rot_grid, mode="bilinear",
                                          padding_mode="zeros", align_corners=True)
    return library, extra


def time_route_limits(dev, gen, card):
    """The measurements behind the route constants of ops/kernels.py, on one
    3840x2160 frame, each route forced through its C entry (no wrapper, so
    no launch counts), and each pair of routes held byte for byte to each
    other: K-median's network and staged counting routes at every network
    radius (MEDIAN_NETWORK_MAX_R); K-blur's short tile (BLUR_SHORT_Q sums a
    thread, BLUR_SHORT_TILE_H rows) and its long one (BLUR_Q, BLUR_TILE_H)
    at r = 1 .. BLUR_SHORT_MAX_R + 2 (BLUR_SHORT_MAX_R), and the long tile
    beside the split route at the last tiled radius and the first split one
    (BLUR_MIN_CHUNK); K-pass's staged route at segments of PASS_MAX_SEG and
    of 1024 outputs beside its global route (PASS_MAX_SEG)."""
    import torch

    from paintfe_tpu_torch.ops import kernels as K
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.utils.cuda_build import check, load_library

    lib = load_library()
    img = _rand(gen, UHD, dev)
    stream = torch.cuda.current_stream().cuda_stream

    def median(route, r):
        out = torch.empty_like(img)
        check(lib.pfe_median(img.data_ptr(), out.data_ptr(), 1, *UHD, r,
                             K._MEDIAN_ROUTES[route], stream), f"pfe_median {route} r={r}")
        return out

    def tiled(taps, th, q):
        out = torch.empty_like(img)
        check(lib.pfe_blur_tiled(img.data_ptr(), out.data_ptr(), 1, *UHD, taps.ctypes.data,
                                 len(taps), th, q, stream), f"pfe_blur_tiled th={th} q={q}")
        return out

    def split(taps):
        out = torch.empty_like(img)
        tmp = torch.empty(UHD + (4,), dtype=torch.float32, device=dev)
        taps_dev = torch.from_numpy(taps).to(dev)
        check(lib.pfe_blur_split(img.data_ptr(), tmp.data_ptr(), out.data_ptr(), 1, *UHD,
                                 taps_dev.data_ptr(), len(taps), stream), "pfe_blur_split")
        return out

    def row(title, runs):
        outs = [fn() for _, fn in runs]
        if any(not torch.equal(o, outs[0]) for o in outs[1:]):
            raise CheckFailed(f"{title}: the routes differ")
        times = [(name, fn, _time_ms(fn)) for name, fn in runs]
        print(f"  {title}: " + ", ".join(f"{name} {ms:.4f} ms (queued "
                                         f"{_queued_ms(fn, ms):.4f} ms)"
                                         for name, fn, ms in times) + f" [card: {card}]")

    planar = img.permute(2, 0, 1).float().contiguous()

    def one_pass(taps_dev, nt, seg):
        out = torch.empty_like(planar)
        check(lib.pfe_blur_pass(planar.data_ptr(), taps_dev.data_ptr(), out.data_ptr(),
                                4 * UHD[0], UHD[1], nt, seg, stream), f"pfe_blur_pass seg={seg}")
        return out

    print(f"route limits at 3840x2160, CUDA events, median of {TIMED_RUNS} [card: {card}]:")
    for r in range(1, K.MEDIAN_NETWORK_MAX_R + 1):
        row(f"K-median r={r}", [("network", lambda r=r: median("network", r)),
                                ("staged", lambda r=r: median("staged", r))])
    short = (K.BLUR_SHORT_TILE_H, K.BLUR_SHORT_Q)
    long = (K.BLUR_TILE_H, K.BLUR_Q)
    last = next(r for r in range(1, 300) if K.blur_tile_rows(r + 1) == 0)
    for r in list(range(1, K.BLUR_SHORT_MAX_R + 3)) + [last, last + 1]:
        taps = gaussian_kernel((r - 0.5) / 3)  # radius r
        runs = [(f"{q} sums x {th} rows", lambda th=th, q=q: tiled(taps, th, q))
                for th, q in (short, long)] if r <= K.BLUR_SHORT_MAX_R + 2 else [
                (f"{long[1]} sums x {long[0]} rows", lambda: tiled(taps, *long)),
                ("split", lambda: split(taps))]
        row(f"K-blur r={r} ({'split' if r > last else 'tiled'} route)", runs)
    # K-pass: the wrapper's segments (at most PASS_MAX_SEG outputs) beside a
    # row in four segments of 960 (the kernel takes up to 1024), and the
    # global route
    for sigma in PASS_SIGMAS:
        taps = gaussian_kernel(sigma)
        taps_dev = torch.from_numpy(taps).to(dev)
        row(f"K-pass sigma={sigma} one pass f32 [4,{UHD[0]},{UHD[1]}]",
            [(f"segments of {seg}" if seg else "global route",
              lambda seg=seg: one_pass(taps_dev, len(taps), seg))
             for seg in (K.pass_segment(UHD[1]), 960, 0)])


def time_kernels(dev, gen, card):
    """The cases of time_cases, then each kernel, its plain version and,
    where one exists, one PyTorch call computing the same function, at
    3840x2160; with each kernel's bound computed from these inputs."""
    import torch
    import torch.nn.functional as F

    from paintfe_tpu_torch.ops.effects.distort import bulge_field
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import (composite_stack_kernel,
                                               composite_stack_plain,
                                               gaussian_blur_fused,
                                               gaussian_blur_pass,
                                               gaussian_blur_pass_plain,
                                               gaussian_blur_plain, median_kernel,
                                               median_plain)
    from paintfe_tpu_torch.ops.warp_kernel import (gather_bilinear_plain,
                                                   gather_bilinear_u8)

    with _section("timed cases"):
        time_cases(dev, gen, card)
    with _section("route limits"):
        time_route_limits(dev, gen, card)
    h, w = UHD
    px = h * w
    frame = px * 4  # bytes of one u8 RGBA frame
    img = _rand(gen, UHD, dev)
    ov = _overlay(gen, UHD, dev)
    sx, sy, _ = bulge_field(0.5, (0.5, 0.5), h, w, dev)

    # yardsticks: inputs laid out for the library call outside the timing
    torch.backends.cudnn.allow_tf32 = False  # an f32 convolution, not TF32
    taps = torch.from_numpy(gaussian_kernel(2.0)).to(dev)
    r = taps.numel() // 2
    img_f = img.permute(2, 0, 1)[None].float().contiguous()
    padded = F.pad(img_f, (r, r, r, r), mode="replicate")
    weight = torch.outer(taps, taps).expand(4, 1, -1, -1).contiguous()
    grid = torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], -1)[None]
    # K-pass: one pass along W of the planar f32 image; the yardstick is a
    # grouped conv1d over the replicate-padded rows (one group a row)
    planar = img.permute(2, 0, 1).float().contiguous()
    taps_np = gaussian_kernel(2.0)
    rows = F.pad(planar, (r, r), mode="replicate")
    row_weight = taps.view(1, 1, -1).expand(h, 1, -1).contiguous()
    # K-composite: four layers over an initial accumulator
    stack = [_rand(gen, UHD, dev) for _ in range(4)]
    init = _rand(gen, UHD, dev)
    modes, opac = TIMED_MODES, TIMED_OPACITIES

    nt = taps.numel()
    blur_ops = 4 * nt * 4 * px  # two passes of nt multiplies and adds, 4 channels
    chain_ops = _chain_ops(ov, nt, px)
    composite_ops = _composite_ops(stack, modes, opac)
    pairs = {
        "fused_chain_kernel": (
            lambda: fused_chain_kernel(img, ov), lambda: fused_chain(img, ov),
            None, _bound(3 * frame, chain_ops, F32_OPS_PER_S)),
        "gaussian_blur_fused": (
            lambda: gaussian_blur_fused(img, 2.0),
            lambda: gaussian_blur_plain(img, 2.0),
            lambda: F.conv2d(padded, weight, groups=4),
            _bound(2 * frame, blur_ops, F32_OPS_PER_S)),
        # a selection reads each of the 25 window values of each channel
        "median_kernel": (
            lambda: median_kernel(img, 2), lambda: median_plain(img, 2), None,
            _bound(2 * frame, 25 * 4 * px, PACKED_BYTE_OPS_PER_S)),
        # bilinear, clamp mode: 12 f32 operations a channel, 4 a pixel for
        # the fractions; source, two f32 fields and the output move once
        "gather_bilinear_u8": (
            lambda: gather_bilinear_u8(img, sx, sy, "clamp"),
            lambda: gather_bilinear_plain(img, sx, sy, "clamp"),
            lambda: F.grid_sample(img_f, grid, mode="bilinear",
                                  padding_mode="border", align_corners=True),
            _bound(frame + 2 * 4 * px + frame, 52 * px, F32_OPS_PER_S)),
        # four layers and the accumulator read once, the result written once
        "composite_stack_kernel": (
            lambda: composite_stack_kernel(stack, modes, opac, None, init),
            lambda: composite_stack_plain(stack, modes, opac, None, init), None,
            _bound((len(stack) + 2) * frame, composite_ops, F32_OPS_PER_S)),
        # one f32 read and one f32 write of [4, H, W]; nt products and sums
        "gaussian_blur_pass": (
            lambda: gaussian_blur_pass(planar, taps_np),
            lambda: gaussian_blur_pass_plain(planar, taps_np),
            lambda: F.conv1d(rows, row_weight, groups=h),
            _bound(2 * 4 * 4 * px, 2 * nt * 4 * px, F32_OPS_PER_S)),
    }
    result = {}
    print(f"timing at 3840x2160, CUDA events, median of {TIMED_RUNS} "
          f"[card: {card}]:")
    for name, (kern, plain, library, (bound_ms, bound_by)) in pairs.items():
        # plain, kernel, kernel, plain: two medians each, on one card
        p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        lib_ms = _time_ms(library) if library is not None else None
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        k_mb, p_mb = _peak_mb(kern), _peak_mb(plain)
        result[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms}
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"  {name}: kernel {k1:.4f} / {k2:.4f} ms ({px / k_ms / 1e6:.3f} "
              f"GPix/s, peak {k_mb:.1f} MiB), plain {p1:.4f} / {p2:.4f} ms "
              f"({px / p_ms / 1e6:.3f} GPix/s, peak {p_mb:.1f} MiB){lib}, "
              f"bound {bound_ms:.4f} ms by {bound_by} "
              f"({bound_ms / k_ms * 100:.1f}% of it) [card: {card}]")
    return result


KERNEL_SOURCES = {
    "gaussian_blur_fused": ("paintfe_tpu_torch/csrc/gaussian_blur.cu",
                            "paintfe_tpu/ops/pallas_kernels.py:347"),
    "fused_chain_kernel": ("paintfe_tpu_torch/csrc/fused_chain.cu",
                           "paintfe_tpu/ops/fused_chain.py:323"),
    "median_kernel": ("paintfe_tpu_torch/csrc/median.cu",
                      "paintfe_tpu/ops/pallas_kernels.py:488"),
    "gather_bilinear_u8": ("paintfe_tpu_torch/csrc/warp_bilinear.cu",
                           "paintfe_tpu/ops/warp_kernel.py:270"),
    "composite_stack_kernel": ("paintfe_tpu_torch/csrc/composite.cu",
                               "paintfe_tpu/ops/pallas_kernels.py:242"),
    "gaussian_blur_pass": ("paintfe_tpu_torch/csrc/blur_pass.cu",
                           "paintfe_tpu/ops/pallas_kernels.py:58"),
}


def print_cases() -> int:
    """`chip_smoke.py --cases`: time_cases and time_flatten on the package
    beside this file, as one JSON line.  To compare two versions of the
    package on one card, run it from each one's directory in turns."""
    import torch

    dev = torch.device("cuda", 0)
    card = _card()
    cases = time_cases(dev, torch.Generator().manual_seed(0), card)
    flatten_ms = time_flatten(dev)
    print(f"flatten of one 3840x2160 document: {flatten_ms:.3f} ms wall [card: {card}]")
    print(json.dumps({"card": card, "cases": cases, "flatten_ms": flatten_ms}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--cases"]:
        return print_cases()
    if sys.argv[1:2] == ["--spatial-process"] and len(sys.argv) == 3:
        return spatial_process(sys.argv[2])
    from paintfe_tpu_torch.parallel.batch import shutdown_encode_pool
    from paintfe_tpu_torch.utils.cuda_build import BUILD_INFO, load_library

    started = time.perf_counter()
    card = _card()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    load_library()
    print(f"kernel build: {BUILD_INFO['seconds']:.3f} s -> {BUILD_INFO['library']}")
    if BUILD_INFO["sources"]:  # a fresh build: each nvcc's own time, all run at once
        print("  nvcc, one process a source: " + ", ".join(
            f"{name} {s:.1f} s" for name, s in BUILD_INFO["sources"].items()))
    if BUILD_INFO["log"]:
        for line in pathlib.Path(BUILD_INFO["log"]).read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    from paintfe_tpu_torch import native

    t0 = time.perf_counter()
    native.load()  # the host C++ (RAW decoders, LZW, NeuQuant, PNG defilter): g++
    print(f"native build: {time.perf_counter() - t0:.3f} s -> {native.library_path()}")

    gen = torch.Generator().manual_seed(0)
    errs = {name: [] for name in KERNEL_SOURCES}
    try:
        with _section("kernel checks"):
            check_blur(dev, gen, errs["gaussian_blur_fused"])
            check_chain(dev, gen, errs["fused_chain_kernel"])
            check_median(dev, gen, errs["median_kernel"])
            check_warp(dev, gen, errs["gather_bilinear_u8"])
            torch.cuda.empty_cache()
            check_composite(dev, gen, errs["composite_stack_kernel"])
            check_composite_paths(dev, gen, errs["composite_stack_kernel"])
            check_blur_pass(dev, gen, errs["gaussian_blur_pass"])
            torch.cuda.empty_cache()
        with _section("effect checks and streams"):
            check_effects(dev, gen)
            check_streams(dev)
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            phases = drive_main_paths(dev, gen, pathlib.Path(tmp), card)
            with _section("input stages timed"):
                time_input_stages(dev, pathlib.Path(tmp) / "inputs", card)
        with _section("time_kernels in all"):
            times = time_kernels(dev, gen, card)
        with _section("effects timed"):
            time_effects(dev, gen, card)
    finally:
        shutdown_encode_pool()

    # launches: summed over the phases; launched_on: the phases that
    # launched it (K-pass only from its entry call, which no CLI path makes)
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(c[name] for c in phases.values()),
         "launched_on": [tag for tag, c in phases.items() if c[name]],
         "max_abs_err": max(errs[name]), **times[name]}
        for name, (source, replaces) in KERNEL_SOURCES.items()]
    print(f"smoke: {time.perf_counter() - started:.1f} s, the kernels' build included "
          f"[card: {card}]; by section: " + ", ".join(f"{name} {sec:.1f} s"
                                                    for name, sec in SECTION_S.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
