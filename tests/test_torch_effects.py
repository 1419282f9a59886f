"""The port's effect ops (ops/filters, ops/effects/{noise,distort,stylize,
artistic}, ops/transform's resize, utils/hashing) against the JAX
package's, on the CPU.

Tolerance 0 where the math is IEEE-basic.  Under the transcendental rule
(ROADMAP C2) twist, reduce-noise and monochrome Gaussian noise build their
cos/sin, exp and log/cos on the host (an f64 libm call of the f32 argument,
rounded once to f32) where XLA evaluates its own f32 versions: tolerance 1
on u8, and the share of differing bytes stays below MAX_SHARE (measured on
these inputs: at most 1 byte of 12,288 for twist and 1 of 49,152 for
reduce-noise, 0 for Gaussian noise).  Glow divides by 255 truly (the
reference) where the JAX package multiplies by the reciprocal (ROADMAP
C9): tolerance 0 against a numpy oracle of the reference formula, 1
against the JAX package."""

import math

import numpy as np
import pytest
import torch

from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.ops import transform as jtfm
from paintfe_tpu.ops.effects import artistic as jartistic
from paintfe_tpu.ops.effects import distort as jdistort
from paintfe_tpu.ops.effects import noise as jnoise
from paintfe_tpu.ops.effects import stylize as jstylize
from paintfe_tpu.utils import hashing as jhashing
from paintfe_tpu_torch.ops import filters, transform
from paintfe_tpu_torch.ops.effects import artistic, distort, noise, stylize
from paintfe_tpu_torch.utils import hashing

# the written C2 tolerance: at most 1 on u8, on under 0.1% of the bytes
MAX_SHARE = 1e-3


def _img(seed, h=48, w=64):
    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    a[: h // 6, :, 3] = 0
    return a


def _port(fn, img, *args):
    return fn(torch.from_numpy(img), *args).numpy()


def _equal(jax_fn, port_fn, img, *args):
    ref = np.asarray(jax_fn(img, *args))
    out = _port(port_fn, img, *args)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def _within_one(ref, out):
    diff = np.abs(np.asarray(ref).astype(int) - out.astype(int))
    assert diff.max() <= 1
    assert np.mean(diff > 0) < MAX_SHARE


@pytest.mark.parametrize("fn,args", [
    ("box_blur", (1.0,)), ("box_blur", (3.0,)), ("box_blur", (0.4,)),
    ("motion_blur", (30.0, 4.0)), ("motion_blur", (-135.0, 2.5)),
    ("motion_blur", (10.0, 0.5)),
    ("sharpen", (1.5, 1.0)), ("sharpen", (-0.7, 1.0)),
])
def test_blur_family_matches_jax(fn, args):
    _equal(getattr(jfilters, fn), getattr(filters, fn), _img(1), *args)


_MODULES = {"distort": (jdistort, distort), "stylize": (jstylize, stylize),
            "artistic": (jartistic, artistic)}


@pytest.mark.parametrize("mod,fn,args", [
    ("distort", "pixelate", (5,)), ("distort", "pixelate", (1,)),
    ("distort", "crystallize", (6.0,)), ("distort", "crystallize", (5.5,)),
    ("distort", "crystallize", (64.0,)),
    ("stylize", "vignette", (0.6, 0.8)), ("stylize", "vignette", (1.5, 0.0)),
    ("stylize", "halftone", (6.0, 45.0)), ("stylize", "halftone", (4.0, 10.0)),
    ("artistic", "ink", (50.0, 30.0)), ("artistic", "ink", (100.0, 5.0)),
    ("artistic", "oil_painting", (2, 20)), ("artistic", "oil_painting", (1, 7)),
])
def test_distort_stylize_artistic_match_jax(mod, fn, args):
    jmod, tmod = _MODULES[mod]
    _equal(getattr(jmod, fn), getattr(tmod, fn), _img(2), *args)


@pytest.mark.parametrize("shape", [0, 1, 2, 3])
def test_halftone_shapes_match_jax(shape):
    _equal(jstylize.halftone, stylize.halftone, _img(3), 5.0, 30.0, shape)


@pytest.mark.parametrize("noise_type", [noise.NoiseType.UNIFORM, noise.NoiseType.PERLIN,
                                        noise.NoiseType.GAUSSIAN])
@pytest.mark.parametrize("mono", [False, True])
def test_noise_matches_jax(noise_type, mono):
    img = _img(4)
    args = (40.0, int(noise_type), mono, 42, 1.5, 3)
    ref = np.asarray(jnoise.add_noise(img, *args))
    out = _port(noise.add_noise, img, *args)
    if noise_type == noise.NoiseType.GAUSSIAN and mono:
        _within_one(ref, out)  # log and cos of hashed coordinates (C2)
    else:
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("amount", [20.0, 100.0])
def test_gaussian_noise_is_within_the_c2_tolerance(amount):
    img = _img(5, 96, 128)
    args = (amount, int(noise.NoiseType.GAUSSIAN), True, 42, 1.0, 1)
    _within_one(jnoise.add_noise(img, *args), _port(noise.add_noise, img, *args))


@pytest.mark.parametrize("angle", [30.0, 90.0, 250.0])
def test_twist_is_within_the_c2_tolerance(angle):
    img = _img(6)
    _within_one(jdistort.twist(img, angle), _port(distort.twist, img, angle))


@pytest.mark.parametrize("strength", [10.0, 25.0, 60.0])
@pytest.mark.parametrize("smooth", [False, True])
def test_reduce_noise_is_within_the_c2_tolerance(strength, smooth):
    img = _img(7, 96, 128)
    if smooth:
        yy, xx = np.mgrid[0:96, 0:128]
        img = np.stack([(2 * xx) % 256, (2 * yy) % 256, (xx + yy) % 256,
                        np.full_like(xx, 255)], axis=-1).astype(np.uint8)
    _within_one(jfilters.reduce_noise(img, strength, 2),
                _port(filters.reduce_noise, img, strength, 2))


def test_reduce_noise_weights_are_the_f64_exp_of_the_f32_argument():
    f32 = np.float32
    rows, table = filters.reduce_noise_weights(25.0, 2)
    assert sorted(rows) == [0, 1, 2, 4, 5, 8] and table.shape == (6, 3 * 255 * 255 + 1)
    sigma_r = f32(25.0) * f32(2.55)
    range_div = f32(2.0) * sigma_r * sigma_r + f32(0.001)
    for q, ssd in [(0, 0), (5, 1234), (8, 195075), (1, 77)]:
        arg = -(f32(q) / f32(8.0)) - f32(ssd) / range_div
        assert table[rows[q], ssd] == f32(math.exp(float(arg)))


def _glow_oracle(src, blur, intensity):
    """The reference's glow formula (stylize.rs:26-72) in numpy f32 with
    true divides by 255."""
    f32 = np.float32
    s = src[..., 0:3].astype(f32) / f32(255.0)
    b = blur[..., 0:3].astype(f32) / f32(255.0)
    res = f32(1.0) - (f32(1.0) - s) * (f32(1.0) - b * f32(intensity))
    rgb = np.clip(np.floor(res * f32(255.0) + f32(0.5)), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, src[..., 3:4]], axis=-1)


@pytest.mark.parametrize("intensity", [0.4, 0.5, 1.0, 1.7])
def test_glow_mix_over_every_pair_is_the_reference_and_within_one_of_jax(intensity):
    # every (src, blur) u8 pair, on all three colour channels
    v = np.arange(256, dtype=np.uint8)
    src = np.repeat(v, 256)[:, None].repeat(4, axis=1)
    blur = np.tile(v, 256)[:, None].repeat(4, axis=1)
    out = filters.glow_mix(torch.from_numpy(src), torch.from_numpy(blur), intensity).numpy()
    np.testing.assert_array_equal(out, _glow_oracle(src, blur, intensity))
    ref = np.asarray(jfilters._glow_mix(src, blur, np.float32(intensity)))
    diff = np.abs(ref.astype(int) - out.astype(int))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 3  # 1 pair x 3 channels (C9)


@pytest.mark.parametrize("radius,intensity", [(3.0, 1.7), (1.0, 0.5)])
def test_glow_is_the_reference_formula_and_within_one_of_jax(radius, intensity):
    img = _img(8)
    out = _port(filters.glow, img, radius, intensity)
    blurred = filters.gaussian_blur(torch.from_numpy(img), radius).numpy()
    np.testing.assert_array_equal(out, _glow_oracle(img, blurred, intensity))
    _within_one(jfilters.glow(img, radius, intensity), out)


@pytest.mark.parametrize("filt", ["nearest", "bilinear", "bicubic", "lanczos3"])
@pytest.mark.parametrize("size", [(37, 71), (130, 20)])
def test_resize_matches_jax(filt, size):
    img = _img(9)
    np.testing.assert_array_equal(transform.resize(img, *size, filt),
                                  jtfm.resize(img, *size, filt))


@pytest.mark.parametrize("anchor", [(0, 0), (1, 1), (2, 0), (1, 2)])
@pytest.mark.parametrize("size", [(80, 30), (41, 61)])
def test_resize_canvas_matches_jax(anchor, size):
    img = _img(10)
    np.testing.assert_array_equal(
        transform.resize_canvas(img, *size, anchor, (1, 2, 3, 4)),
        jtfm.resize_canvas(img, *size, anchor, (1, 2, 3, 4)))


def test_ops_take_a_batch_and_a_mask():
    imgs = np.stack([_img(11), _img(12)])
    mask = np.zeros((48, 64), np.uint8)
    mask[5:30, 10:50] = 1
    for fn, args in [(filters.box_blur, (2.0,)), (distort.crystallize, (7.0,)),
                     (artistic.oil_painting, (2, 20)), (filters.reduce_noise, (30.0, 2)),
                     (stylize.vignette, (0.7, 0.5)), (noise.add_noise, (30.0,))]:
        batch = fn(torch.from_numpy(imgs), *args, mask=mask).numpy()
        for k in range(2):
            one = fn(torch.from_numpy(imgs[k]), *args).numpy()
            want = np.where(mask[..., None] > 0, one, imgs[k])
            np.testing.assert_array_equal(batch[k], want, err_msg=fn.__name__)


def test_frame_slices_do_not_change_the_result():
    from paintfe_tpu_torch.ops.common import by_frames

    imgs = torch.from_numpy(np.stack([_img(13 + k) for k in range(5)]))
    run = lambda x: filters.reduce_noise(x, 20.0, 2)  # noqa: E731
    np.testing.assert_array_equal(by_frames(run, imgs, max_px=2 * 48 * 64).numpy(),
                                  run(imgs).numpy())


@pytest.mark.parametrize("seed", [0, 1, 42, 119, 2 ** 31 - 1])
def test_hash_matches_jax_on_a_grid(seed):
    ys, xs = np.mgrid[-300:300, -200:200]
    np.testing.assert_array_equal(hashing.hash_f32(xs, ys, seed),
                                  np.asarray(jhashing.hash_f32(xs, ys, seed)))
    vals = (np.arange(1 << 16, dtype=np.int64) * 65521 + seed) & 0xFFFFFFFF
    np.testing.assert_array_equal(hashing.hash_u32(vals),
                                  np.asarray(jhashing.hash_u32(vals.astype(np.uint32))))


@pytest.mark.parametrize("octaves,roughness", [(1, 0.5), (3, 0.5), (2, 0.7)])
def test_turbulence_matches_jax(octaves, roughness):
    ys, xs = np.mgrid[0:40, 0:50].astype(np.float32) * np.float32(0.37)
    np.testing.assert_array_equal(
        hashing.turbulence_2d(xs, ys, 42, octaves, roughness),
        np.asarray(jhashing.turbulence_2d(xs, ys, 42, octaves, roughness)))


def _all_values():
    """Every u8 value in each colour channel, a random alpha."""
    v = np.arange(256, dtype=np.uint8)
    img = np.stack([v, v[::-1], np.roll(v, 77), v], axis=-1).reshape(16, 16, 4)
    img[..., 3] = np.random.default_rng(14).integers(0, 256, (16, 16))
    return img


def _jax_per_image(name, img, *args):
    from paintfe_tpu.scripting.api import ScriptContext, build_host_fns

    ctx = ScriptContext(img, img.shape[1], img.shape[0], None, rng_seed=0)
    build_host_fns(ctx, {})[name](*args)
    return ctx.pixels


def _port_per_image(name, img, *args):
    from paintfe_tpu_torch.scripting.api import ScriptContext, build_host_fns

    ctx = ScriptContext(img, img.shape[1], img.shape[0], None, rng_seed=0, device="cpu")
    build_host_fns(ctx, {})[name](*args)
    return ctx.pixels


@pytest.mark.parametrize("half", [0, 1])
def test_exposure_sweep_matches_both_jax_paths(half):
    """ev over [-4, 4] in steps of 0.01 (801 values, half of them a case):
    the port's gain (an f64 pow rounded once) on both of its paths gives
    the u8 output of the JAX package's per-image numpy power and of its
    batch path's exp2, whose gains part on 271 of the 801 (ROADMAP C6)."""
    import jax

    from paintfe_tpu.parallel import pipeline as jpipe
    from paintfe_tpu_torch.parallel import pipeline as tpipe

    img = _all_values()
    evs = [round(-4.0 + 0.01 * k, 2) for k in range(801)][half::2]
    batch_ref = np.asarray(jax.jit(jax.vmap(lambda ev: jpipe._exposure_device(img, ev)))(
        np.asarray(evs, np.float32)))
    for k, ev in enumerate(evs):
        port_batch = tpipe._exposure_device(torch.from_numpy(img), ev).numpy()
        port_one = _port_per_image("apply_exposure", img, ev)
        np.testing.assert_array_equal(port_batch, batch_ref[k], err_msg=f"ev {ev}")
        np.testing.assert_array_equal(port_one, _jax_per_image("apply_exposure", img, ev),
                                      err_msg=f"ev {ev}")
        np.testing.assert_array_equal(port_one, port_batch, err_msg=f"ev {ev}")


def test_desaturate_matches_jax_on_both_paths():
    from paintfe_tpu.ops.adjustments import desaturate_bt601
    from paintfe_tpu_torch.parallel import pipeline as tpipe

    img = _all_values()
    ref = np.asarray(desaturate_bt601(img))
    np.testing.assert_array_equal(tpipe._desaturate_device(torch.from_numpy(img)).numpy(), ref)
    np.testing.assert_array_equal(_port_per_image("apply_desaturate", img), ref)
