"""The port's flood fill, magic wand and colour removal
(paintfe_tpu_torch.ops.{fill,color_removal}) against the JAX package's:
the perceptual and legacy distance maps, the 256-entry sRGB -> linear
table against jnp.power, the reachability loop (4- and 8-connectivity,
a serpentine maze), the wand (contiguous, global, AA fringe, a pocket),
bucket fill, colour-to-alpha, flood select and the smart eraser.  The
same seeded inputs, device "cpu", tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paintfe_tpu.core import fixtures as jfixtures
from paintfe_tpu.ops import color_removal as jcr
from paintfe_tpu.ops import fill as jfill
from paintfe_tpu_torch.core import fixtures as tfixtures
from paintfe_tpu_torch.ops import color_removal as tcr
from paintfe_tpu_torch.ops import fill as tfill

H, W = 48, 64


def _noise_image(seed, h=H, w=W, levels=6, alpha_zero=True):
    """Flat patches of a few colours with a little noise, so distance maps
    cover both small and large values and regions are contiguous but not
    trivial."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (levels, 4), np.uint8)
    palette[:, 3] = rng.choice([0, 128, 255], levels) if alpha_zero else 255
    labels = rng.integers(0, levels, (h // 8 + 1, w // 8 + 1))
    labels = np.repeat(np.repeat(labels, 8, 0), 8, 1)[:h, :w]
    img = palette[labels].astype(np.int16)
    img += rng.integers(-3, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _t(img):
    return torch.from_numpy(np.ascontiguousarray(img))


def test_srgb_table_equals_jnp_power_on_every_u8_input():
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    want = np.asarray(jax.jit(jfill._srgb_to_linear)(jnp.asarray(v)))
    table = tfill.srgb_to_linear_table()
    assert table.dtype == np.float32
    assert np.array_equal(table.view(np.uint32), want.view(np.uint32))
    # the power alone, eagerly, on the inputs above the linear segment
    base = ((v + np.float32(0.055)) / np.float32(1.055)).astype(np.float32)
    high = v > np.float32(0.04045)
    eager = np.asarray(jnp.power(jnp.asarray(base), 2.4))
    assert high.sum() == 245
    assert np.array_equal(table[high].view(np.uint32), eager[high].view(np.uint32))
    # the exponent must be f32(2.4): with the f64 2.4, 153 of the 245 differ
    exact = np.power(base.astype(np.float64), 2.4).astype(np.float32)
    assert int((exact[high] != eager[high]).sum()) == 153


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("metric", ["perceptual", "legacy"])
def test_distance_maps_equal_jax(seed, metric):
    img = _noise_image(seed)
    rng = np.random.default_rng(100 + seed)
    targets = [img[5, 7], img[30, 40], np.array([0, 0, 0, 0], np.uint8),
               rng.integers(0, 256, 4, np.uint8)]
    jmap = jfill.perceptual_distance_map if metric == "perceptual" else jfill.legacy_distance_map
    tmap = tfill.perceptual_distance_map if metric == "perceptual" else tfill.legacy_distance_map
    for target in targets:
        want = np.asarray(jmap(jnp.asarray(img), target))
        got = tmap(_t(img), target).numpy()
        assert got.dtype == np.uint8 and np.array_equal(got, want), target


def test_perceptual_distance_map_over_every_channel_value():
    """Every u8 value in every channel once against three targets."""
    v = np.arange(256, dtype=np.uint8)
    img = np.stack([v, v[::-1], np.roll(v, 77), np.roll(v, 13)], -1).reshape(16, 16, 4)
    for target in ([12, 200, 3, 255], [255, 255, 255, 0], [90, 91, 92, 7]):
        want = np.asarray(jfill.perceptual_distance_map(jnp.asarray(img), np.uint8(target)))
        got = tfill.perceptual_distance_map(_t(img), np.uint8(target)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("tolerance", [0.0, 7.5, 25.0, 60.0, 100.0])
@pytest.mark.parametrize("anti_aliased", [False, True])
def test_threshold_alpha_equals_jax(tolerance, anti_aliased):
    d = np.arange(256, dtype=np.uint8).reshape(16, 16)
    thr = tfill.tolerance_threshold_u8(tolerance)
    assert thr == jfill.tolerance_threshold_u8(tolerance)
    want = np.asarray(jfill.threshold_alpha(jnp.asarray(d), thr, anti_aliased))
    assert np.array_equal(tfill.threshold_alpha(_t(d), thr, anti_aliased).numpy(), want)


@pytest.mark.parametrize("trial", range(3))
@pytest.mark.parametrize("conn8", [False, True])
def test_reachability_equals_jax(trial, conn8):
    rng = np.random.default_rng(5 + trial)
    passable = rng.random((H, W)) < 0.55
    passable[10, 10] = True
    reach, iters = jfill._reachability_iters(jnp.asarray(passable), 10, 10,
                                             connectivity8=conn8)
    got, n = tfill._reachability_iters(_t(passable), 10, 10, conn8)
    assert np.array_equal(got.numpy(), np.asarray(reach))
    assert n == int(iters)


def _serpentine(h, w, pitch=4):
    passable = np.ones((h, w), bool)
    for k, y in enumerate(range(pitch, h - 1, pitch)):
        passable[y, :] = False
        passable[y, w - 2 if k % 2 == 0 else 1] = True
    return passable


@pytest.mark.parametrize("conn8", [False, True])
def test_serpentine_reach_equals_jax_and_converges_per_turn(conn8):
    h = w = 128
    passable = _serpentine(h, w)
    reach, iters = jfill._reachability_iters(jnp.asarray(passable), 0, 0,
                                             connectivity8=conn8)
    got, n = tfill._reachability_iters(_t(passable), 0, 0, conn8)
    assert np.array_equal(got.numpy(), np.asarray(reach))
    assert got.numpy().sum() == passable.sum()
    assert n == int(iters) and n <= h // 4 + 8


def test_reachability_blocked_seed():
    got, n = tfill._reachability_iters(torch.zeros((16, 16), dtype=torch.bool), 3, 3)
    assert not got.any() and n == 1


WAND_CASES = [
    # (x, y, tolerance, contiguous, anti_aliased, connectivity8, metric)
    (7, 5, 12.0, True, True, False, "perceptual"),
    (7, 5, 12.0, True, True, True, "perceptual"),
    (40, 30, 4.0, True, False, True, "perceptual"),
    (40, 30, 30.0, False, True, False, "perceptual"),
    (40, 30, 30.0, False, False, False, "perceptual"),
    (3, 40, 9.0, True, True, False, "legacy"),
    (3, 40, 9.0, True, False, True, "legacy"),
    (60, 2, 50.0, True, True, True, "perceptual"),
]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", WAND_CASES, ids=str)
def test_magic_wand_equals_jax(seed, case):
    x, y, tol, contiguous, aa, conn8, metric = case
    img = _noise_image(seed)
    want = jfill.magic_wand_mask(img, x, y, tol, contiguous, aa, conn8, metric)
    got = tfill.magic_wand_mask(img, x, y, tol, contiguous, aa, conn8, metric, device="cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("aa", [False, True])
def test_wand_pocket_behind_a_fringe_ring_equals_jax(aa):
    img = np.zeros((9, 9, 4), np.uint8)
    img[...] = [10, 10, 10, 255]
    img[2:7, 2:7] = [60, 10, 10, 255]
    img[4, 4] = [10, 10, 10, 255]
    tol = 49 / 255 * 100
    want = jfill.magic_wand_mask(img, 0, 0, tol, True, aa, metric="legacy")
    got = tfill.magic_wand_mask(img, 0, 0, tol, True, aa, metric="legacy", device="cpu")
    assert np.array_equal(got, want)
    assert got[4, 4] == (128 if aa else 0)


@pytest.mark.parametrize("case", [(2, 2, 25.0, True, False), (30, 20, 10.0, True, True),
                                  (11, 40, 40.0, False, False), (0, 0, 0.0, True, False)])
def test_bucket_fill_equals_jax(case):
    x, y, tol, contiguous, aa = case
    img = _noise_image(3)
    want = jfill.bucket_fill(img, x, y, (0, 255, 0, 255), tol, contiguous, aa)
    got = tfill.bucket_fill(img, x, y, (0, 255, 0, 255), tol, contiguous, aa, device="cpu")
    assert np.array_equal(got, want)


def test_wand_on_fixtures_equals_jax():
    for img in (jfixtures.color_bands(64, 48), jfixtures.test_gradient(64, 48),
                jfixtures.blend_test_foreground(64, 48)):
        for tol in (5.0, 20.0):
            want = jfill.magic_wand_mask(img, 30, 20, tol, connectivity8=True)
            got = tfill.magic_wand_mask(img, 30, 20, tol, connectivity8=True, device="cpu")
            assert np.array_equal(got, want)


def test_fixtures_equal_jax():
    for name in ("test_gradient", "test_checkerboard", "transparent", "color_bands",
                 "blend_test_foreground"):
        for w, h in ((1, 2), (37, 23), (64, 48)):
            assert np.array_equal(getattr(tfixtures, name)(w, h),
                                  getattr(jfixtures, name)(w, h)), (name, w, h)
    assert np.array_equal(tfixtures.solid(5, 3, (1, 2, 3, 4)), jfixtures.solid(5, 3, (1, 2, 3, 4)))


C2A_SETTINGS = [
    dict(),
    dict(target=(255, 0, 0), tolerance=40.0, softness=10.0),
    dict(target=(0, 128, 255), strength=0.6, spill_suppression=0.0, protect_luminance=0.0),
    dict(target=(200, 200, 200), alpha_floor=0.1, alpha_ceiling=0.9, softness=80.0),
]


@pytest.mark.parametrize("k", range(len(C2A_SETTINGS)))
@pytest.mark.parametrize("masked", [False, True])
def test_color_to_alpha_equals_jax(k, masked):
    img = _noise_image(11 + k)
    img[::7, ::5, :3] = C2A_SETTINGS[k].get("target", (255, 0, 0))
    mask = (np.random.default_rng(k).random((H, W)) < 0.5).astype(np.uint8) * 255 \
        if masked else None
    want = jcr.color_to_alpha(img, jcr.ColorToAlphaSettings(**C2A_SETTINGS[k]), mask)
    got = tcr.color_to_alpha(img, tcr.ColorToAlphaSettings(**C2A_SETTINGS[k]), mask)
    assert np.array_equal(got, want)


FLOOD_CASES = [(5, 5, 10.0, False, True), (20, 30, 3.0, False, True),
               (20, 30, 30.0, True, True), (40, 10, 15.0, False, False),
               (0, 0, 50.0, True, False)]


@pytest.mark.parametrize("case", FLOOD_CASES, ids=str)
def test_flood_select_equals_jax(case):
    x, y, tol, with_sel, contiguous = case
    img = _noise_image(21)
    sel = None
    if with_sel:
        sel = np.zeros((H, W), np.uint8)
        sel[4:40, 3:60] = 255
    want = jcr.flood_select(img, x, y, tol, selection=sel, contiguous=contiguous)
    got = tcr.flood_select(img, x, y, tol, selection=sel, contiguous=contiguous,
                           device="cpu")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("smoothness", [0, 2, 5])
@pytest.mark.parametrize("with_sel", [False, True])
def test_smart_contiguous_erase_equals_jax(smoothness, with_sel):
    img = _noise_image(31, alpha_zero=False)
    sel = None
    if with_sel:
        sel = np.zeros((H, W), np.uint8)
        sel[:, 10:] = 255
    want = jcr.smart_contiguous_erase(img, 20, 20, 12.0, smoothness, selection=sel)
    got = tcr.smart_contiguous_erase(img, 20, 20, 12.0, smoothness, selection=sel,
                                     device="cpu")
    assert np.array_equal(got, want)


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _noise_image(0, alpha_zero=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfill.magic_wand_mask(img, 0, 0, 10.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcr.flood_select(img, 5, 5, 10.0)
