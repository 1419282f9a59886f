"""The port's adjustment stack (ops/luts, ops/adjustments) against the JAX
package's, on the CPU, with and without a selection mask.

Tolerance 0 everywhere but one place.  The JAX `luts.levels_lut` raises
to the power with numpy's f32 `np.power`, which on AVX-512 hosts takes a
SIMD path that is 1 ulp off on some inputs (ROADMAP C11); the port's table
takes the correctly rounded power (an f64 libm pow rounded once to f32).
Against the JAX table: tolerance 1 on u8, on at most LEVELS_LUT_SHARE of
the entries (measured: 1 of 76,800 entries over 100 gammas x 3 black/white
ranges on an AVX-512 host).  Against the JAX package's
per-pixel `jnp.power` paths (`levels_direct`, `_levels_per_channel_fn`):
tolerance 0.  The JAX package's TPU-only branches (`_curves_direct_fn`,
`_gradient_map_stops_fn`, `_levels_per_channel_fn`) are oracles here too,
called directly."""

import numpy as np
import pytest
import torch

from paintfe_tpu.ops import adjustments as jadj
from paintfe_tpu.ops import luts as jluts
from paintfe_tpu_torch.ops import adjustments as adj
from paintfe_tpu_torch.ops import luts

f32 = np.float32

# the written C11 tolerance: at most 1 on u8, on at most this share of the
# table entries (measured 1 / 76,800 on an AVX-512 host)
LEVELS_LUT_SHARE = 1e-3

# ROADMAP C12: entries where the JAX per-pixel curves differ from its table
# (test_curves_table_and_per_pixel_paths_differ_c12)
CURVES_C12_DIFFER = 15

GAMMAS = np.linspace(0.1, 9.99, 100)
RANGES = [(0, 255), (10, 245), (30, 200)]
SHAPES = [(64, 64), (96, 128)]


def _img(seed, h, w):
    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    a[: h // 6, :, 3] = 0
    a[h // 3: h // 2, : w // 4] = (200, 30, 30, 255)  # a flat red patch
    return a


def _mask(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    m = ((xx - w / 2) ** 2 / (w * 0.35) ** 2 + (yy - h / 2) ** 2 / (h * 0.4) ** 2) <= 1.0
    out = np.where(m, 255, 0).astype(np.uint8)
    out[0, 0] = 7  # any non-zero value selects
    return out


CURVES = [
    ([(0, 0), (64, 80), (190, 170), (255, 255)], True),
    ([(0, 20), (255, 235)], True),
    ([(0, 0), (128, 200), (255, 255)], False),
    ([(0, 255), (120, 40), (121, 200), (255, 0)], True),
    ([(10, 0), (250, 255)], True),
]
STOPS = [(0.0, (10, 20, 120, 255)), (0.35, (240, 90, 20, 200)),
         (0.35, (0, 255, 0, 255)), (1.0, (255, 250, 220, 255))]

# (function, args); each runs with and without a mask, at each shape
CASES = [
    ("invert_colors", ()), ("invert_alpha", ()), ("sepia", ()), ("desaturate", ()),
    ("desaturate_bt601", ()), ("auto_levels", ()),
    ("brightness_contrast", (10.0, 15.0)), ("brightness_contrast", (-40.0, -80.0)),
    ("brightness_contrast", (0.0, 258.0)),
    ("hue_saturation_lightness", (30.0, 20.0, -10.0)),
    ("hue_saturation_lightness", (-170.0, -60.0, 35.0)),
    ("exposure", (0.7,)), ("exposure", (-1.3,)), ("exposure", (2.0,)),
    ("highlights_shadows", (40.0, -30.0)), ("highlights_shadows", (-70.0, 55.0)),
    ("temperature_tint", (25.0, -12.0)), ("temperature_tint", (-33.3, 7.7)),
    ("threshold", (128.0,)), ("threshold", (37.5,)),
    ("posterize", (4,)), ("posterize", (7,)), ("posterize", (1,)),
    ("color_balance", ((10.0, -5.0, 20.0), (0.0, 15.0, -10.0), (-20.0, 5.0, 30.0))),
    ("gradient_map", (jluts.gradient_map_lut(STOPS),)),
    ("gradient_map_stops", (STOPS,)),
    ("black_and_white", (40.0, 40.0, 20.0)), ("black_and_white", (120.0, -30.0, 55.5)),
    ("vibrance", (45.0,)), ("vibrance", (-60.0,)),
    ("apply_rgb_lut", (jluts.curves_lut(CURVES[0][0]),)),
    ("apply_rgba_luts", (jluts.multi_channel_luts(CURVES),)),
    ("levels", (10, 240, 1.3, 5, 250)), ("levels", (0, 200, 0.5, 0, 255)),
    ("levels_direct", (20, 230, 2.2, 0, 255)),
    ("levels_per_channel", ((5, 250, 1.1, 0, 255), (0, 240, 0.8, 10, 250),
                            (20, 255, 1.4, 0, 255), (0, 255, 1.0, 30, 220))),
    ("curves", (CURVES,)),
    ("curves_direct", (CURVES,)),
    ("hue_saturation_per_band", (10.0, 5.0, -5.0, (20, -30, 0, 45, -10, 5),
                                 (10, 0, -40, 20, 30, -15), (5, -5, 10, 0, -20, 15))),
    ("hue_saturation_per_band", (-90.0, -20.0, 12.0, (180, -180, 90, -90, 33, 0),
                                 (100, -100, 50, -50, 0, 25), (-100, 100, -50, 50, 0, 5))),
]


def _case_id(case):
    return case[0]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_adjustment_equals_jax(case, with_mask, shape):
    name, args = case
    img = _img(len(name) + 3 * len(args), *shape)
    mask = _mask(*shape) if with_mask else None
    ref = np.asarray(getattr(jadj, name)(img, *args, mask=mask))
    out = getattr(adj, name)(img, *args, mask=mask, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "mask"])
def test_histogram_equals_jax(with_mask, shape):
    img = _img(11, *shape)
    mask = _mask(*shape) if with_mask else None
    ref = np.asarray(jadj.histogram(img, mask=mask))
    out = adj.histogram(torch.from_numpy(img), mask=mask)
    assert out.dtype == torch.int32 and out.shape == (4, 256)
    np.testing.assert_array_equal(out.numpy(), ref)
    want = (mask > 0).sum() if with_mask else shape[0] * shape[1]
    assert out.sum(dim=1).tolist() == [want] * 4


def test_every_public_adjustment_is_ported():
    names = [n for n, v in vars(jadj).items()
             if callable(v) and not n.startswith("_") and getattr(v, "__module__", "")
             in ("paintfe_tpu.ops.adjustments", None)]
    names = [n for n in names if n not in ("hsl_to_rgb", "rgb_to_hsl", "luma_bt709",
                                           "exact_div", "exact_div_hw", "round_u8")]
    assert len(names) >= 27
    missing = [n for n in names if not callable(getattr(adj, n, None))]
    assert missing == []
    assert adj.BAND_CENTERS == jadj.BAND_CENTERS


# ---------------------------------------------------------------------------
# The TPU-only oracles of the JAX package, called directly on the CPU
# ---------------------------------------------------------------------------


def _curves_key(channel_points):
    return tuple((tuple((float(x), float(y)) for x, y in pts) if pts else (), bool(en))
                 for pts, en in channel_points)


CURVE_SETS = [CURVES, CURVES[::-1], [(CURVES[3][0], True), ([], True), ([], False),
                                     (CURVES[1][0], True), (CURVES[4][0], True)]]


@pytest.mark.parametrize("k", range(len(CURVE_SETS)))
def test_curves_direct_equals_the_per_pixel_oracle(k):
    pts = CURVE_SETS[k]
    img = _img(20 + k, 64, 64)
    ref = np.asarray(jadj._curves_direct_fn(_curves_key(pts))(img))
    np.testing.assert_array_equal(adj.curves_direct(img, pts, device="cpu").numpy(), ref)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 4, axis=2)
    np.testing.assert_array_equal(adj.curves_direct_luts(pts),
                                  np.asarray(jadj.curves_direct(ramp, pts))[0].T)


def test_curves_table_and_per_pixel_paths_differ_c12():
    """ROADMAP C12: the JAX package's two curves paths are not bit-identical
    (its docstring says they are).  Over the 256 u8 inputs of each channel
    of CURVE_SETS the per-pixel path differs from the table on
    CURVES_C12_DIFFER of the 3 x 4 x 256 entries, by at most 2 (a curve
    alone differs by 1; the RGB curve composed with a steep channel curve
    by 2); the port follows each JAX function (curves: the table,
    curves_direct: the per-pixel math)."""
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 4, axis=2)
    differ = 0
    for pts in CURVE_SETS:
        table = np.asarray(jadj.curves(ramp, pts))[0]
        direct = np.asarray(jadj.curves_direct(ramp, pts))[0]
        d = np.abs(table.astype(int) - direct.astype(int))
        assert d.max() <= 2
        differ += int((d > 0).sum())
        np.testing.assert_array_equal(adj.curves(ramp, pts, device="cpu").numpy()[0], table)
    assert differ == CURVES_C12_DIFFER


@pytest.mark.parametrize("k", range(3))
def test_gradient_map_stops_equals_the_per_pixel_oracle(k):
    stops = [STOPS, [(0.2, (255, 0, 0, 255)), (0.8, (0, 0, 255, 255))],
             [(0.5, (1, 2, 3, 4))]][k]
    key = tuple((float(st[0]), tuple(float(c) for c in st[1]))
                for st in sorted(stops, key=lambda st: st[0]))
    img = _img(30 + k, 64, 64)
    ref = np.asarray(jadj._gradient_map_stops_fn(key)(img))
    np.testing.assert_array_equal(adj.gradient_map_stops(img, stops, device="cpu").numpy(),
                                  ref)


@pytest.mark.parametrize("gamma", [0.3, 0.8, 1.0, 1.7, 2.2, 4.5])
def test_levels_per_channel_equals_the_jnp_power_oracle(gamma):
    chans = ((5.0, 250.0, gamma, 0.0, 255.0), (0.0, 240.0, 0.8, 0.0, 255.0),
             (20.0, 255.0, 1.4, 0.0, 255.0), (0.0, 255.0, gamma * 0.5, 0.0, 255.0))
    img = _img(40, 64, 64)
    ref = np.asarray(jadj._levels_per_channel_fn(chans)(img))
    out = adj.levels_per_channel(img, *chans, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# The LUT constructors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(0, 255), (12, 200), (100, 101), (90, 90), (200, 10)])
def test_stretch_lut_equals_jax(lo, hi):
    np.testing.assert_array_equal(luts.stretch_lut(lo, hi), jluts.stretch_lut(lo, hi))


@pytest.mark.parametrize("k", range(len(CURVES)))
def test_curves_lut_and_tangents_equal_jax(k):
    pts = CURVES[k][0]
    np.testing.assert_array_equal(luts.curves_lut(pts), jluts.curves_lut(pts))
    for a, b in zip(luts.curves_tangents(pts), jluts.curves_tangents(pts)):
        np.testing.assert_array_equal(a, b)
    assert luts.curves_tangents(pts[:1]) is None and jluts.curves_tangents(pts[:1]) is None


def test_composed_and_multi_channel_luts_equal_jax():
    np.testing.assert_array_equal(luts.identity_lut(), jluts.identity_lut())
    a, b = luts.curves_lut(CURVES[0][0]), luts.curves_lut(CURVES[3][0])
    np.testing.assert_array_equal(luts.compose_luts(a, b), jluts.compose_luts(a, b))
    np.testing.assert_array_equal(luts.multi_channel_luts(CURVES),
                                  jluts.multi_channel_luts(CURVES))
    chans = [(5, 250, 1.1, 0, 255), (0, 240, 0.8, 10, 250), (20, 255, 1.0, 0, 255),
             (0, 255, 1.0, 0, 255)]
    np.testing.assert_array_equal(luts.levels_multi_channel_luts(*chans),
                                  jluts.levels_multi_channel_luts(*chans))


@pytest.mark.parametrize("k", range(3))
def test_gradient_map_lut_equals_jax(k):
    stops = [STOPS, [], [(0.4, (9, 8, 7, 6))]][k]
    np.testing.assert_array_equal(luts.gradient_map_lut(stops),
                                  jluts.gradient_map_lut(stops))


@pytest.mark.parametrize("lo,hi", RANGES)
def test_levels_lut_equals_the_correctly_rounded_power_c11(lo, hi):
    """ROADMAP C11: the port's levels table equals the JAX package's
    jnp.power evaluation (`_levels_eval`, which its levels_direct and
    per-channel paths run) on every u8 input at tolerance 0, and the JAX
    numpy-power table within 1 on at most LEVELS_LUT_SHARE of the entries
    (100 gammas x 256 inputs a black/white range)."""
    import jax.numpy as jnp

    v = jnp.arange(256, dtype=jnp.float32)
    lut_diff = 0
    for g in GAMMAS:
        port = luts.levels_lut(lo, hi, g, 0, 255)
        direct = np.asarray(jadj._levels_eval(v, lo, hi, g, 0, 255)).astype(np.uint8)
        np.testing.assert_array_equal(port, direct)
        numpy_pow = jluts.levels_lut(lo, hi, g, 0, 255)
        d = np.abs(port.astype(int) - numpy_pow.astype(int))
        assert d.max() <= 1
        lut_diff += int((d > 0).sum())
    assert lut_diff / (len(GAMMAS) * 256) <= LEVELS_LUT_SHARE


@pytest.mark.parametrize("out_range", [(0, 255), (20, 230), (255, 0)])
def test_levels_lut_output_range_equals_jnp_power(out_range):
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 4, axis=2)
    for g in (0.45, 1.0, 2.6):
        port = luts.levels_lut(15, 235, g, *out_range)
        direct = np.asarray(jadj.levels_direct(ramp, 15, 235, g, *out_range))[0, :, 0]
        np.testing.assert_array_equal(port, direct)


def test_correct_pow_is_the_rounded_f64_power():
    base = np.linspace(0, 1, 257, dtype=f32)
    got = luts.correct_pow(base, f32(1 / 2.2))
    want = np.power(base.astype(np.float64), np.float64(f32(1 / 2.2))).astype(f32)
    np.testing.assert_array_equal(got, want)


def test_remainder_equals_jnp_remainder_on_the_cpu():
    """hue_saturation_per_band's floor-mod: torch.remainder equals
    jnp.remainder bitwise on random f32, divisors 1 and 360."""
    import jax.numpy as jnp

    x = np.random.default_rng(3).uniform(-1000, 1000, 1 << 16).astype(f32)
    for d in (1.0, 360.0):
        got = torch.remainder(torch.from_numpy(x), d).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(jnp.remainder(x, f32(d))).view(np.uint32))
