"""The port's Bézier strokes, lasso and perspective crop
(paintfe_tpu_torch.tools.vector_tools) on the CPU against the JAX
package's paintfe_tpu.tools.vector_tools, tolerance 0: every pattern x cap
x arrow side x anti-aliasing under a selection, the filled triangle, the
line falloff; every lasso mode from no selection and from one; the crop of
a document with masks and a text layer, skewed and degenerate quads; the
cases of tests/test_vector_tools.py.  Inputs are numpy-seeded."""

import numpy as np
import pytest
import torch

from paintfe_tpu.core import fixtures
from paintfe_tpu.core.canvas import Canvas as JCanvas
from paintfe_tpu.core.selection import SelectionMode as JMode
from paintfe_tpu.ops import text_layer as jtext
from paintfe_tpu.tools import vector_tools as jvt
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.core.selection import SelectionMode as TMode
from paintfe_tpu_torch.tools import vector_tools as tvt

import chip_smoke

W, H = 96, 72
CPS = [(5.5, 60.2), (30.0, -10.0), (70.0, 90.0), (90.3, 10.1)]


def _selection():
    sel = np.zeros((H, W), np.uint8)
    sel[5:60, 10:90] = 255
    return sel


def _noise(seed):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 4), np.uint8)


def _both(make, draw_j, draw_t):
    want = make()
    got = torch.from_numpy(want.copy())
    draw_j(want)
    draw_t(got)
    return got.numpy(), want


@pytest.mark.parametrize("pattern", ["solid", "dotted", "dashed"])
@pytest.mark.parametrize("cap", ["round", "flat"])
@pytest.mark.parametrize("arrow", ["none", "start", "end", "both"])
@pytest.mark.parametrize("aa", [True, False], ids=["aa", "aliased"])
def test_bezier_equals_jax(pattern, cap, arrow, aa):
    kw = dict(pattern=pattern, cap_style=cap, anti_alias=aa, selection=_selection(),
              arrow_side=arrow)
    got, want = _both(lambda: _noise(3),
                      lambda i: jvt.rasterize_bezier(i, CPS, (200, 30, 40, 220), 5.0, **kw),
                      lambda i: tvt.rasterize_bezier(i, CPS, (200, 30, 40, 220), 5.0, **kw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [0.6, 2.0, 4.0, 13.0])
def test_bezier_sizes_equal_jax(size):
    """The falloff's three radius regimes (below 1.5, below 3, above)."""
    sel = _selection()
    got, want = _both(lambda: np.zeros((H, W, 4), np.uint8),
                      lambda i: jvt.rasterize_bezier(i, CPS, (0, 255, 0, 128), size,
                                                     selection=sel, arrow_side="end"),
                      lambda i: tvt.rasterize_bezier(i, CPS, (0, 255, 0, 128), size,
                                                     selection=sel, arrow_side="end"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tri", [((10.5, 10.2), (60.0, 20.0), (30.0, 65.5)),
                                 ((30.0, 65.5), (60.0, 20.0), (10.5, 10.2)),
                                 ((-20.0, -5.0), (50.0, 3.0), (4.0, 80.0)),
                                 ((5.0, 5.0), (5.0, 5.0), (5.0, 5.0))],
                         ids=["ccw", "cw", "off-canvas", "degenerate"])
def test_filled_triangle_equals_jax(tri):
    got, want = _both(lambda: _noise(4),
                      lambda i: jvt.draw_filled_triangle(i, *tri, (9, 80, 200, 200),
                                                         _selection()),
                      lambda i: tvt.draw_filled_triangle(i, *tri, (9, 80, 200, 200),
                                                         _selection()))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [0.7, 2.2, 9.0])
@pytest.mark.parametrize("hardness", [0.0, 0.95, 1.5])
@pytest.mark.parametrize("aa", [True, False])
def test_line_alpha_equals_jax(radius, hardness, aa):
    dist = np.random.default_rng(6).random(500, np.float32) * (radius + 4.0)
    np.testing.assert_array_equal(
        tvt.compute_line_alpha(torch.from_numpy(dist), radius, hardness, aa).numpy(),
        jvt.compute_line_alpha(dist, radius, hardness, aa))


def test_bezier_point_equals_jax():
    for t in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert tvt.bezier_point(*CPS, t) == jvt.bezier_point(*CPS, t)


def test_bezier_cases_of_the_jax_tests():
    """tests/test_vector_tools.py: near-continuous solid coverage, dashes
    with gaps, the end arrow past P3 and the start arrow behind P0."""
    line = [(5, 32), (25, 32), (40, 32), (58, 32)]

    def run(points, size, **kw):
        got, want = _both(lambda: np.zeros((64, 64, 4), np.uint8),
                          lambda i: jvt.rasterize_bezier(i, points, (255, 0, 0, 255), size, **kw),
                          lambda i: tvt.rasterize_bezier(i, points, (255, 0, 0, 255), size, **kw))
        np.testing.assert_array_equal(got, want)
        return got

    solid = run(line, 4.0)
    assert (solid[32, 6:58, 3] > 0).mean() > 0.9
    assert (run(line, 4.0, pattern="dashed")[..., 3] > 0).sum() < (solid[..., 3] > 0).sum()
    flat = run(line, 4.0, cap_style="flat")
    assert ((flat[..., 3] > 0) & ~(solid[..., 3] > 0)).sum() == 0
    pts = ((20.0, 32.0), (30.0, 32.0), (40.0, 32.0), (50.0, 32.0))
    start = run(pts, 3.0, arrow_side="start")
    assert (start[:, 14:17, 3] > 0).any() and not (start[:, :14, 3] > 0).any()
    end = run(pts, 3.0, arrow_side="end")
    assert (end[:, 51:, 3] > 0).sum() > (run(pts, 3.0)[:, 51:, 3] > 0).sum()


LASSOS = [[(3.3, 4.1), (80.2, 10.5), (60.0, 70.7), (20.5, 50.0)],
          [(10, 10), (50, 10), (50, 50), (10, 50)],
          [(-5.0, 30.0), (40.0, -8.0), (120.0, 40.0), (50.5, 80.0), (45.0, 30.5)],
          [(0, 0), (20, 0)]]


@pytest.mark.parametrize("start", ["none", "some"])
@pytest.mark.parametrize("mode", ["REPLACE", "ADD", "SUBTRACT", "INTERSECT"])
@pytest.mark.parametrize("poly", range(len(LASSOS)))
def test_lasso_equals_jax(start, mode, poly):
    jc = JCanvas.new(W, H)
    if start == "some":
        jc.selection = _selection()
    tc = canvas_from_document(jc)
    jvt.apply_lasso_selection(jc, LASSOS[poly], JMode[mode])
    tvt.apply_lasso_selection(tc, LASSOS[poly], TMode[mode])
    assert (tc.selection is None) == (jc.selection is None)
    if jc.selection is not None:
        np.testing.assert_array_equal(tc.selection, jc.selection)
    np.testing.assert_array_equal(tvt.lasso_mask(LASSOS[poly], W, H),
                                  jvt.lasso_mask(LASSOS[poly], W, H))


def _document():
    """Three layers: noise with a mask, a text layer in need of a
    rasterize, and a gradient."""
    rng = np.random.default_rng(8)
    jc = JCanvas.new(W, H)
    jc.layers[0].pixels = rng.integers(0, 256, (H, W, 4), np.uint8)
    jc.layers[0].mask = rng.integers(0, 256, (H, W), np.uint8)
    from paintfe_tpu.core.canvas import Layer

    text = Layer.new("caption", W, H)
    text.content = "text"
    text.text_data = jtext.make_text_layer_data("Crop", 8.0, 20.0, size=18.0)
    jc.layers.append(text)
    grad = Layer.new("gradient", W, H)
    grad.pixels = np.asarray(fixtures.test_gradient(W, H))
    jc.layers.append(grad)
    jc.selection = _selection()
    return jc


@pytest.mark.parametrize("corners", [
    [(5.5, 3.2), (90.1, 8.7), (80.4, 70.0), (2.2, 60.3)],
    [(8, 8), (40, 8), (40, 40), (8, 40)],
    [(-10.0, -4.0), (120.0, 2.0), (99.0, 90.0), (0.0, 75.0)],
    [(60.5, 50.5), (10.0, 40.0), (20.0, 5.0), (70.0, 10.0)],
    [(10, 10), (11, 10), (11, 11), (10, 11)],
], ids=["skewed", "square", "beyond", "flipped", "degenerate"])
def test_perspective_crop_equals_jax(corners):
    jc = _document()
    tc = canvas_from_document(jc)
    ok = jvt.apply_perspective_crop(jc, corners)
    assert tvt.apply_perspective_crop(tc, corners, device="cpu") == ok
    assert chip_smoke.document_differences(tc, canvas_from_document(jc)) == []
    if ok:
        assert tc.selection is None and tc.layers[1].content == "raster"


def test_perspective_crop_center_sampling():
    """tests/test_vector_tools.py: output pixel (0, 0) of the axis-aligned
    crop samples the source at (8.5, 8.5) with rounding lerps."""
    src = np.asarray(fixtures.test_gradient(64, 64))
    jc = JCanvas.from_image(src)
    tc = canvas_from_document(jc)
    jvt.apply_perspective_crop(jc, [(8, 8), (40, 8), (40, 40), (8, 40)])
    assert tvt.apply_perspective_crop(tc, [(8, 8), (40, 8), (40, 40), (8, 40)], device="cpu")
    assert (tc.width, tc.height) == (32, 32)
    np.testing.assert_array_equal(tc.layers[0].pixels, jc.layers[0].pixels)

    def lerp(a, b, t):
        return np.clip(np.floor(a * (1 - t) + b * t + 0.5), 0, 255)

    p = src.astype(np.float32)
    top = lerp(p[8, 8], p[8, 9], 0.5)
    bot = lerp(p[9, 8], p[9, 9], 0.5)
    np.testing.assert_array_equal(tc.layers[0].pixels[0, 0], lerp(top, bot, 0.5))


def test_crop_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tc = canvas_from_document(_document())
    with pytest.raises(RuntimeError, match="CUDA"):
        tvt.apply_perspective_crop(tc, [(5, 5), (50, 5), (50, 50), (5, 50)])
