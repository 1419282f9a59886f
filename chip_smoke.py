#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (paintfe_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc.
It builds the port's CUDA kernels from csrc/, then:

  1. holds each kernel against its plain version on the card, byte for
     byte (tolerance 0), over several radii, fields and shapes: K-blur
     (csrc/gaussian_blur.cu) against gaussian_blur_plain, K-chain
     (csrc/fused_chain.cu) against the plain fused_chain, K-median
     (csrc/median.cu) against median_plain and K-warp
     (csrc/warp_bilinear.cu) in both modes against gather_bilinear_plain;
  2. drives two main paths, each with every kernel launch count set to 0
     just before it and read just after:
     - the headline path: the serial CLI (three 3840x2160 PNGs, --device
       cuda) and the --shard CLI (six 3840x2160 and two 1920x1080 PNGs,
       two shape buckets) on the headline script, then the headline 4K
       chain frame;
     - the spatial-effects path: the same two CLI runs on a script that
       blurs, takes the median, bulges and applies levels;
     each output must equal the same steps run through the plain versions
     on the card, each kernel of the path must have launched, and each
     kernel of the script must have launched exactly once per serial image
     and once per --shard bucket (a bucket that fell back to the per-image
     path would launch it once per image);
  3. times each kernel beside its plain version at 3840x2160 with CUDA
     events (median of 15 runs after warm-up), and beside one PyTorch call
     computing the same function where there is one.

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}.  Any failed
check exits non-zero before that line.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
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
TIMED_RUNS = 15
# K-median checks, (shape, radius): r = 110 takes the global route
MEDIAN_CHECKS = ([(shape, r) for shape in [(37, 53), (257, 511), UHD] for r in (1, 2, 4)]
                 + [((257, 511), 40), ((37, 53), 110)])
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12


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
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_fused, median_kernel
    from paintfe_tpu_torch.ops.warp_kernel import gather_bilinear_u8

    return {"gaussian_blur_fused": gaussian_blur_fused,
            "fused_chain_kernel": fused_chain_kernel,
            "median_kernel": median_kernel,
            "gather_bilinear_u8": gather_bilinear_u8}


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _rand(gen, shape, device):
    import torch

    return torch.randint(0, 256, tuple(shape) + (4,), generator=gen,
                         dtype=torch.uint8, device="cpu").to(device)


def _max_err(a, b):
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def _compare(name, got, want, errs):
    import torch

    torch.cuda.synchronize()
    err = _max_err(got, want) if got.shape == want.shape else 256
    errs.append(err)
    if got.shape != want.shape or err != 0:
        where = ""
        if got.shape == want.shape:
            bad = (got != want).nonzero()
            first = tuple(bad[0].tolist())
            where = (f", {bad.shape[0]} bytes differ, first at {first}: "
                     f"{got[first[:-1]].tolist()} vs {want[first[:-1]].tolist()}")
        raise CheckFailed(f"{name}: kernel differs from its plain version "
                          f"(max abs err {err}, shapes {tuple(got.shape)} "
                          f"vs {tuple(want.shape)}{where})")
    print(f"  ok  {name}")


def check_blur(dev, gen, errs):
    from paintfe_tpu_torch.ops.kernels import (gaussian_blur_fused,
                                               gaussian_blur_plain)

    print("K-blur vs gaussian_blur_plain (byte-equal):")
    for shape in [(37, 53), (257, 511), UHD]:
        img = _rand(gen, shape, dev)
        for sigma in (0.5, 2.0, 8.0, 25.0, 60.0):
            _compare(f"sigma={sigma} {shape[1]}x{shape[0]}",
                     gaussian_blur_fused(img, sigma),
                     gaussian_blur_plain(img, sigma), errs)
    # radius 240: no 8-row tile fits shared memory, the split kernels run
    for shape in [(37, 53), (257, 511)]:
        img = _rand(gen, shape, dev)
        _compare(f"sigma=80 (split route) {shape[1]}x{shape[0]}",
                 gaussian_blur_fused(img, 80.0), gaussian_blur_plain(img, 80.0),
                 errs)
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


def check_chain(dev, gen, errs):
    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel

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


def check_median(dev, gen, errs):
    import torch

    from paintfe_tpu_torch.ops.kernels import median_kernel, median_plain, median_route

    print("K-median vs median_plain (byte-equal):")
    for shape, r in MEDIAN_CHECKS:
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


def check_warp(dev, gen, errs):
    from paintfe_tpu_torch.ops.warp_kernel import (gather_bilinear_plain,
                                                   gather_bilinear_u8)

    print("K-warp vs gather_bilinear_plain (byte-equal):")
    for shape in [(257, 511), UHD]:
        src = _rand(gen, shape, dev)
        for name, (sx, sy) in _warp_fields(gen, *shape, dev).items():
            for mode in ("zero", "clamp"):
                _compare(f"{mode} {name} {shape[1]}x{shape[0]}",
                         gather_bilinear_u8(src, sx, sy, mode),
                         gather_bilinear_plain(src, sx, sy, mode), errs)
    for shape in [(3, 257, 511), (4,) + UHD]:  # one field for the batch
        batch = _rand(gen, shape, dev)
        sx, sy = _warp_fields(gen, *shape[1:], dev)["bulge 0.5"]
        _compare(f"clamp bulge batch [{','.join(map(str, shape))},4]",
                 gather_bilinear_u8(batch, sx, sy, "clamp"),
                 gather_bilinear_plain(batch, sx, sy, "clamp"), errs)


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


def _drive_cli(dev, tmp, tag, script, plain_steps, script_kernels, seed):
    """The serial CLI on three 3840x2160 PNGs (with its per-stage times),
    then --shard on six 3840x2160 and two 1920x1080 PNGs (two shape
    buckets); checks exit codes, launch counts per image and per bucket,
    and every output against `plain_steps` on the card."""
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
                           [(f"s{k}.png", UHD) for k in range(3)], seed)
    shard = _write_inputs(root / "shard", [(f"u{k}.png", UHD) for k in range(6)]
                          + [(f"f{k}.png", FHD) for k in range(2)], seed + 1)
    argv = ["-s", str(root / "fx.rhai"), "-f", "png", "--device", "cuda"]
    c0 = _counts()
    t0 = time.perf_counter()
    # --profile: the serial run prints load / script / encode per image
    rc_serial = cli.main(["-i", str(root / "serial" / "*.png"), "--output-dir",
                          str(root / "out_serial"), "--profile", *argv])
    t1 = time.perf_counter()
    c1 = _counts()
    rc_shard = cli.main(["-i", str(root / "shard" / "*.png"), "--output-dir",
                         str(root / "out_shard"), "--shard", *argv])
    t2 = time.perf_counter()
    c2 = _counts()
    print(f"  {tag}: serial CLI rc {rc_serial} ({t1 - t0:.3f} s, 3 x 4K), "
          f"--shard CLI rc {rc_shard} ({t2 - t1:.3f} s, 6 x 4K + 2 x 1080p)")
    if rc_serial != 0 or rc_shard != 0:
        raise CheckFailed(f"{tag}: CLI exit codes: serial {rc_serial}, "
                          f"shard {rc_shard}")
    for name in script_kernels:
        n_serial, n_shard = c1[name] - c0[name], c2[name] - c1[name]
        if n_serial != 3:
            raise CheckFailed(f"{tag}: the serial CLI launched {name} "
                              f"{n_serial} times for 3 images, expected 3")
        if n_shard != 2:
            raise CheckFailed(f"{tag}: --shard launched {name} {n_shard} times "
                              "for 2 shape buckets, expected 2: a bucket did "
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
    print(f"  ok  {tag}: CLI outputs (serial 3, --shard 8) equal the plain "
          "steps; one launch per serial image and per --shard bucket")


def _check_launched(tag, counts, names):
    print(f"  {tag} launches: {counts}")
    for name in names:
        if counts[name] == 0:
            raise CheckFailed(f"{name} was not launched on the {tag} path")


def drive_main_paths(dev, gen, tmp):
    """Both main paths, each with launch counts from 0.  Returns the
    launches of each kernel, summed over the paths."""
    import torch

    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel

    print("main paths (launch counts from 0 before each):")
    img = _rand(gen, UHD, dev)
    ov = _overlay(gen, UHD, dev)
    _reset_counts()
    _drive_cli(dev, tmp, "headline", HEADLINE, _plain_headline,
               ("gaussian_blur_fused",), 1)
    head = fused_chain_kernel(img, ov)
    torch.cuda.synchronize()
    headline = _counts()
    _check_launched("headline", headline,
                    ("gaussian_blur_fused", "fused_chain_kernel"))
    if not torch.equal(head, fused_chain(img, ov)):
        raise CheckFailed("headline chain frame differs from the plain chain")
    print("  ok  the headline frame equals the plain chain")

    _reset_counts()
    _drive_cli(dev, tmp, "spatial", SPATIAL, _plain_spatial,
               ("gaussian_blur_fused", "median_kernel", "gather_bilinear_u8"), 3)
    torch.cuda.synchronize()
    spatial = _counts()
    _check_launched("spatial", spatial,
                    ("gaussian_blur_fused", "median_kernel", "gather_bilinear_u8"))
    return {k: headline[k] + spatial[k] for k in headline}


def _time_ms(fn, runs=TIMED_RUNS):
    import torch

    for _ in range(3):
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


def time_kernels(dev, gen, card):
    """Each kernel, its plain version and, where one exists, one PyTorch
    call computing the same function, at 3840x2160; with each kernel's
    bound computed from these inputs."""
    import torch
    import torch.nn.functional as F

    from paintfe_tpu_torch.ops.effects.distort import bulge_field
    from paintfe_tpu_torch.ops.filters import gaussian_kernel
    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import (gaussian_blur_fused,
                                               gaussian_blur_plain, median_kernel,
                                               median_plain)
    from paintfe_tpu_torch.ops.warp_kernel import (gather_bilinear_plain,
                                                   gather_bilinear_u8)

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

    nt = taps.numel()
    blur_ops = 4 * nt * 4 * px  # two passes of nt multiplies and adds, 4 channels
    # the chain's tail: 36 f32 operations a pixel, 55 more where the
    # overlay is not clear (its soft-light Porter-Duff)
    chain_ops = blur_ops + 36 * px + 55 * int((ov[..., 3] != 0).sum())
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
            _bound(2 * frame, 25 * 4 * px, INT8_OPS_PER_S)),
        # bilinear, clamp mode: 12 f32 operations a channel, 4 a pixel for
        # the fractions; source, two f32 fields and the output move once
        "gather_bilinear_u8": (
            lambda: gather_bilinear_u8(img, sx, sy, "clamp"),
            lambda: gather_bilinear_plain(img, sx, sy, "clamp"),
            lambda: F.grid_sample(img_f, grid, mode="bilinear",
                                  padding_mode="border", align_corners=True),
            _bound(frame + 2 * 4 * px + frame, 52 * px, F32_OPS_PER_S)),
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
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    from paintfe_tpu_torch.parallel.batch import shutdown_encode_pool
    from paintfe_tpu_torch.utils.cuda_build import BUILD_INFO, load_library

    card = _card()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    load_library()
    print(f"kernel build: {BUILD_INFO['seconds']:.3f} s -> {BUILD_INFO['library']}")
    if BUILD_INFO["log"]:
        for line in pathlib.Path(BUILD_INFO["log"]).read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    errs = {name: [] for name in KERNEL_SOURCES}
    try:
        check_blur(dev, gen, errs["gaussian_blur_fused"])
        check_chain(dev, gen, errs["fused_chain_kernel"])
        check_median(dev, gen, errs["median_kernel"])
        check_warp(dev, gen, errs["gather_bilinear_u8"])
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            launches = drive_main_paths(dev, gen, pathlib.Path(tmp))
        times = time_kernels(dev, gen, card)
    finally:
        shutdown_encode_pool()

    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": max(errs[name]),
         **times[name]}
        for name, (source, replaces) in KERNEL_SOURCES.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
