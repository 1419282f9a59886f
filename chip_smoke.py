#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (paintfe_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc.
It builds the port's CUDA kernels from csrc/, then:

  1. holds K-blur (csrc/gaussian_blur.cu) against gaussian_blur_plain and
     K-chain (csrc/fused_chain.cu) against the plain fused_chain, both on
     the card, byte for byte (tolerance 0), over several radii and shapes;
  2. drives the main path with every kernel launch count at 0: the serial
     CLI (three 3840x2160 PNGs, --device cuda), the --shard CLI (six
     3840x2160 and two 1920x1080 PNGs, two shape buckets) and the headline
     4K chain frame; each output must equal the same steps run through the
     plain versions on the card, and each kernel must have launched;
  3. times each kernel beside its plain version at 3840x2160 with CUDA
     events (median of 15 runs after warm-up).

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
TIMED_RUNS = 15


class CheckFailed(Exception):
    pass


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise CheckFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def _rand(gen, shape, device):
    import torch

    return torch.randint(0, 256, tuple(shape) + (4,), generator=gen,
                         dtype=torch.uint8, device="cpu").to(device)


def _max_err(a, b):
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def _compare(name, got, want, errs):
    import torch

    torch.cuda.synchronize()
    err = _max_err(got, want)
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


def _plain_script_chain(img):
    """The headline script's steps through the plain versions."""
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_plain
    from paintfe_tpu_torch.parallel.pipeline import (_bc_device, _levels_device,
                                                     _sepia_device)

    x = gaussian_blur_plain(img, 2.0)
    x = _bc_device(x, 10.0, 20.0)
    x = _levels_device(x, 10.0, 245.0, 1.1)
    return _sepia_device(x, 0.5)


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


def drive_main_path(dev, gen, tmp):
    """The main path with launch counts from 0: serial CLI, --shard CLI and
    the headline chain frame.  Returns the counts."""
    import numpy as np
    import torch
    from PIL import Image

    from paintfe_tpu_torch import cli
    from paintfe_tpu_torch.core.canvas import canonicalize_tiles
    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_fused

    (tmp / "fx.rhai").write_text(HEADLINE)
    serial_in = tmp / "serial"
    shard_in = tmp / "shard"
    serial_in.mkdir()
    shard_in.mkdir()
    serial = _write_inputs(serial_in, [(f"s{k}.png", UHD) for k in range(3)], 1)
    shard = _write_inputs(
        shard_in, [(f"u{k}.png", UHD) for k in range(6)]
        + [(f"f{k}.png", FHD) for k in range(2)], 2)
    img = _rand(gen, UHD, dev)
    ov = _overlay(gen, UHD, dev)

    gaussian_blur_fused.launches = 0
    fused_chain_kernel.launches = 0
    t0 = time.perf_counter()
    rc_serial = cli.main(["-i", str(serial_in / "*.png"), "-s", str(tmp / "fx.rhai"),
                          "--output-dir", str(tmp / "out_serial"), "-f", "png",
                          "--device", "cuda"])
    blur_after_serial = gaussian_blur_fused.launches
    t1 = time.perf_counter()
    rc_shard = cli.main(["-i", str(shard_in / "*.png"), "-s", str(tmp / "fx.rhai"),
                         "--output-dir", str(tmp / "out_shard"), "-f", "png",
                         "--device", "cuda", "--shard"])
    t2 = time.perf_counter()
    head = fused_chain_kernel(img, ov)
    torch.cuda.synchronize()
    counts = {"gaussian_blur_fused": gaussian_blur_fused.launches,
              "fused_chain_kernel": fused_chain_kernel.launches}
    print(f"main path: serial CLI rc {rc_serial} ({t1 - t0:.3f} s, 3 x 4K), "
          f"--shard CLI rc {rc_shard} ({t2 - t1:.3f} s, 6 x 4K + 2 x 1080p), "
          f"launches {counts}")

    if rc_serial != 0 or rc_shard != 0:
        raise CheckFailed(f"CLI exit codes: serial {rc_serial}, shard {rc_shard}")
    if blur_after_serial != 3:
        raise CheckFailed(f"serial CLI launched K-blur {blur_after_serial} "
                          "times, expected 3")
    if counts["gaussian_blur_fused"] <= 3:
        raise CheckFailed("--shard CLI did not launch K-blur")
    for name, n in counts.items():
        if n == 0:
            raise CheckFailed(f"{name} was not launched on the main path")

    def expect(arr):
        return _plain_script_chain(torch.from_numpy(arr).to(dev)).cpu().numpy()

    for name, arr in serial.items():
        got = np.asarray(Image.open(tmp / "out_serial" / name))
        if not np.array_equal(got, canonicalize_tiles(expect(arr))):
            raise CheckFailed(f"serial CLI output {name} differs from the plain steps")
    for name, arr in shard.items():
        got = np.asarray(Image.open(tmp / "out_shard" / name))
        if not np.array_equal(got, expect(arr)):
            raise CheckFailed(f"--shard CLI output {name} differs from the plain steps")
    if not torch.equal(head, fused_chain(img, ov)):
        raise CheckFailed("headline chain frame differs from the plain chain")
    print("  ok  CLI outputs (serial 3, --shard 8) and the headline frame equal "
          "the plain versions")
    return counts


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


def time_kernels(dev, gen, card):
    from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
    from paintfe_tpu_torch.ops.kernels import (gaussian_blur_fused,
                                               gaussian_blur_plain)

    img = _rand(gen, UHD, dev)
    ov = _overlay(gen, UHD, dev)
    pairs = {
        "fused_chain_kernel": (lambda: fused_chain_kernel(img, ov),
                               lambda: fused_chain(img, ov)),
        "gaussian_blur_fused": (lambda: gaussian_blur_fused(img, 2.0),
                                lambda: gaussian_blur_plain(img, 2.0)),
    }
    px = UHD[0] * UHD[1]
    result = {}
    print(f"timing at 3840x2160, CUDA events, median of {TIMED_RUNS} "
          f"[card: {card}]:")
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: two medians each, on one card
        p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        k_mb, p_mb = _peak_mb(kern), _peak_mb(plain)
        result[name] = (k_ms, p_ms)
        print(f"  {name}: kernel {k1:.4f} / {k2:.4f} ms ({px / k_ms / 1e6:.3f} "
              f"GPix/s, peak {k_mb:.1f} MiB), plain {p1:.4f} / {p2:.4f} ms "
              f"({px / p_ms / 1e6:.3f} GPix/s, peak {p_mb:.1f} MiB) [card: {card}]")
    return result


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
    blur_errs, chain_errs = [], []
    try:
        check_blur(dev, gen, blur_errs)
        check_chain(dev, gen, chain_errs)
        with tempfile.TemporaryDirectory() as tmp:
            counts = drive_main_path(dev, gen, pathlib.Path(tmp))
        times = time_kernels(dev, gen, card)
    finally:
        shutdown_encode_pool()

    kernels = [
        {"name": "gaussian_blur_fused", "route": "cuda",
         "source": "paintfe_tpu_torch/csrc/gaussian_blur.cu",
         "replaces": "paintfe_tpu/ops/pallas_kernels.py:347",
         "launches": counts["gaussian_blur_fused"],
         "max_abs_err": max(blur_errs),
         "ms": times["gaussian_blur_fused"][0],
         "plain_ms": times["gaussian_blur_fused"][1]},
        {"name": "fused_chain_kernel", "route": "cuda",
         "source": "paintfe_tpu_torch/csrc/fused_chain.cu",
         "replaces": "paintfe_tpu/ops/fused_chain.py:323",
         "launches": counts["fused_chain_kernel"],
         "max_abs_err": max(chain_errs),
         "ms": times["fused_chain_kernel"][0],
         "plain_ms": times["fused_chain_kernel"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
