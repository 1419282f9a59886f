"""The port's selections, colour spaces and soft proof
(paintfe_tpu_torch.core.{selection,colorspace,mirror}) against the JAX
package's: shape masks, the four combine modes, translate, feather,
expand/contract, select_color_range, fill/delete on partial masks,
rgb_to_hsl / hsl_to_rgb on tensors and on numpy, the integer luma, the
mirror positions and the CMYK soft proof.  The same seeded inputs,
tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paintfe_tpu.core import colorspace as jcs
from paintfe_tpu.core import fixtures as jfixtures
from paintfe_tpu.core import mirror as jmirror
from paintfe_tpu.core import selection as jsel
from paintfe_tpu_torch.core import colorspace as tcs
from paintfe_tpu_torch.core import mirror as tmirror
from paintfe_tpu_torch.core import selection as tsel

H, W = 72, 96


def _rand_mask(seed, h=H, w=W, partial=True):
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((h, w)) < 0.4, 255, 0).astype(np.uint8)
    m[h // 4:h // 2, w // 4:w // 2] = 255
    if partial:
        m[rng.random((h, w)) < 0.15] = rng.integers(1, 255, 1, np.uint8)
    return m


@pytest.mark.parametrize("rect", [(10, 5, 40, 30), (-5, -5, 3, 200), (90, 70, 200, 200),
                                  (50, 20, 40, 10)])
def test_rect_mask_equals_jax(rect):
    assert np.array_equal(tsel.rect_mask(W, H, *rect), jsel.rect_mask(W, H, *rect))


@pytest.mark.parametrize("ell", [(48.0, 36.0, 30.0, 20.0), (0.5, 70.2, 12.7, 40.1),
                                 (48.0, 36.0, 0.0, 10.0), (10.3, 10.9, 200.0, 3.3)])
def test_ellipse_mask_equals_jax(ell):
    assert np.array_equal(tsel.ellipse_mask(W, H, *ell), jsel.ellipse_mask(W, H, *ell))


@pytest.mark.parametrize("mode", ["replace", "add", "subtract", "intersect"])
@pytest.mark.parametrize("with_base", [False, True])
def test_combine_equals_jax(mode, with_base):
    base = _rand_mask(1) if with_base else None
    new = _rand_mask(2)
    got = tsel.combine(base, new, tsel.SelectionMode(mode), W, H)
    want = jsel.combine(base, new, jsel.SelectionMode(mode), W, H)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("d", [(0, 0), (7, -3), (-20, 11), (200, 0), (-5, -90)])
def test_translate_equals_jax(d):
    m = _rand_mask(3)
    assert np.array_equal(tsel.translate(m, *d), jsel.translate(m, *d))


@pytest.mark.parametrize("radius", [0.5, 1.0, 2.0, 4.0, 7.5, 20.0])
def test_feather_equals_jax(radius):
    m = _rand_mask(4)
    assert np.array_equal(tsel.feather(m, radius), jsel.feather(m, radius))


@pytest.mark.parametrize("radius", [0, 1, 3, 6])
@pytest.mark.parametrize("op", ["expand", "contract"])
def test_expand_contract_equal_jax(radius, op):
    m = _rand_mask(5)
    assert np.array_equal(getattr(tsel, op)(m, radius), getattr(jsel, op)(m, radius))


CR_CASES = [(0.0, 30.0, 0.2, 0.5), (120.0, 60.0, 0.0, 1.0), (240.0, 10.0, 0.5, 0.05),
            (300.0, 90.0, 0.1, 0.001), (45.0, 0.0, 0.0, 0.3)]


@pytest.mark.parametrize("case", CR_CASES, ids=str)
@pytest.mark.parametrize("mode", ["replace", "add", "intersect"])
def test_select_color_range_equals_jax(case, mode):
    img = np.random.default_rng(6).integers(0, 256, (H, W, 4), np.uint8)
    img[:8] = jfixtures.color_bands(W, 8)
    img[8:16, :, 3] = 0
    base = _rand_mask(7)
    got = tsel.select_color_range(img, *case, base=base, mode=tsel.SelectionMode(mode))
    want = jsel.select_color_range(img, *case, base=base, mode=jsel.SelectionMode(mode))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("none_mask", [False, True])
def test_fill_and_delete_selected_equal_jax(partial, none_mask):
    px = np.random.default_rng(8).integers(0, 256, (H, W, 4), np.uint8)
    mask = None if none_mask else _rand_mask(9, partial=partial)
    color = (12, 250, 99, 200)
    assert np.array_equal(tsel.fill_selected(px, mask, color),
                          jsel.fill_selected(px, mask, color))
    assert np.array_equal(tsel.delete_selected(px, mask), jsel.delete_selected(px, mask))


def _unit_channels(seed, n=4096):
    """Every u8 value / 255 and random ones, with grays and ties."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
    rgb[:256, 0] = np.arange(256)
    rgb[256:512] = np.arange(256)[:, None]  # grays
    rgb[512:768, 1] = rgb[512:768, 0]  # R = G ties
    rgb[768:1024, 2] = rgb[768:1024, 1]  # G = B ties
    return [c / np.float32(255.0) for c in rgb.T]


@pytest.mark.parametrize("seed", range(3))
def test_rgb_to_hsl_equals_jax_on_tensors_and_numpy(seed):
    r, g, b = _unit_channels(seed)
    want = [np.asarray(x) for x in jcs.rgb_to_hsl(jnp.asarray(r), jnp.asarray(g),
                                                  jnp.asarray(b))]
    got = [x.numpy() for x in tcs.rgb_to_hsl(torch.from_numpy(r), torch.from_numpy(g),
                                             torch.from_numpy(b))]
    for a, e in zip(got, want):
        assert np.array_equal(a.view(np.uint32), e.view(np.uint32))
    want_np = jcs.rgb_to_hsl(r, g, b, xp=np)
    got_np = tcs.rgb_to_hsl(r, g, b)
    for a, e in zip(got_np, want_np):
        assert np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                              np.asarray(e, np.float32).view(np.uint32))


@pytest.mark.parametrize("seed", range(3))
def test_hsl_to_rgb_equals_jax_on_tensors_and_numpy(seed):
    rng = np.random.default_rng(20 + seed)
    h, s, l = (rng.random(4096).astype(np.float32) for _ in range(3))
    s[:300] = 0.0
    h[300:600] = np.float32(1.0) / np.float32(6.0)
    l[600:900] = np.float32(0.5)
    want = [np.asarray(x) for x in jcs.hsl_to_rgb(jnp.asarray(h), jnp.asarray(s),
                                                  jnp.asarray(l))]
    got = [x.numpy() for x in tcs.hsl_to_rgb(torch.from_numpy(h), torch.from_numpy(s),
                                             torch.from_numpy(l))]
    for a, e in zip(got, want):
        assert np.array_equal(a.view(np.uint32), e.view(np.uint32))
    for a, e in zip(tcs.hsl_to_rgb(h, s, l), jcs.hsl_to_rgb(h, s, l, xp=np)):
        assert np.array_equal(np.asarray(a, np.float32), np.asarray(e, np.float32))


def test_hsl_round_trip_equals_jax():
    r, g, b = _unit_channels(30)
    want = jcs.hsl_to_rgb(*jcs.rgb_to_hsl(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b)))
    got = tcs.hsl_to_rgb(*tcs.rgb_to_hsl(torch.from_numpy(r), torch.from_numpy(g),
                                         torch.from_numpy(b)))
    for a, e in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(e))


def test_luma_bt601_int_equals_jax():
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v[::3], v[::5], indexing="ij")
    want = np.asarray(jcs.luma_bt601_int(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b)))
    got = tcs.luma_bt601_int(torch.from_numpy(r), torch.from_numpy(g), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tcs.luma_bt601_int(r, g, b), want)


@pytest.mark.parametrize("seed", range(3))
def test_soft_proof_cmyk_equals_jax(seed):
    img = np.random.default_rng(40 + seed).integers(0, 256, (H, W, 4), np.uint8)
    img[:4] = jfixtures.color_bands(W, 4)
    img[4:6, :, :3] = 0
    img[6:8, :, 3] = 0
    assert np.array_equal(tmirror.soft_proof_cmyk(img), jmirror.soft_proof_cmyk(img))
    rgb = img[..., :3]
    assert np.array_equal(tmirror.rgb_to_cmyk(rgb), jmirror.rgb_to_cmyk(rgb))
    cmyk = jmirror.rgb_to_cmyk(rgb)
    assert np.array_equal(tmirror.cmyk_to_rgb(cmyk), jmirror.cmyk_to_rgb(cmyk))


@pytest.mark.parametrize("mode", ["none", "horizontal", "vertical", "quarters"])
def test_mirror_positions_equal_jax(mode):
    t, j = tmirror.MirrorMode(mode), jmirror.MirrorMode(mode)
    assert t.mirror_positions(3.5, 7.0, 64, 48) == j.mirror_positions(3.5, 7.0, 64, 48)
    assert t.next().value == j.next().value and t.is_active == j.is_active
