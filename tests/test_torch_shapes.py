"""The port's SDF shapes and custom SVG shapes (paintfe_tpu_torch.ops.shapes)
on the CPU against the JAX package's paintfe_tpu.ops.shapes, tolerance 0:
every ShapeKind x fill mode x anti-aliasing, rotated and not, with a corner
radius; the SDFs themselves; the SVG path parser's commands (absolute and
relative, smooth curves, arcs with compact flags), its bounding box and
errors; custom shapes in every fill mode and the picker icon; the cases of
tests/test_shapes.py.  The polygon and star SDFs take their arctan2 and
cos/sin from the host's numpy (ROADMAP C2), so they too are exact."""

import numpy as np
import pytest
import torch

from paintfe_tpu.ops import shapes as jshapes
from paintfe_tpu_torch.ops import shapes as tshapes

W, H = 96, 72


def _placed(kind, fill, aa=True, rotation=0.0, corner=6.0, custom=None, **over):
    spec = dict(cx=40.3, cy=30.7, hw=25.2, hh=18.9, rotation=rotation, kind=kind,
                fill_mode=fill, outline_width=3.5, primary_color=(200, 60, 30, 230),
                secondary_color=(20, 90, 250, 255), anti_alias=aa, corner_radius=corner,
                custom_shape_data=custom)
    spec.update(over)
    return jshapes.PlacedShape(**spec)


def _raster_pair(placed, w=W, h=H):
    want = jshapes.rasterize_to_canvas(placed, w, h)
    got = tshapes.rasterize_to_canvas(tshapes.PlacedShape.from_jax(placed), w, h,
                                      device="cpu")
    return got.numpy(), want


@pytest.mark.parametrize("kind", list(jshapes.ShapeKind), ids=lambda k: k.value)
@pytest.mark.parametrize("fill", list(jshapes.ShapeFillMode), ids=lambda f: f.value)
@pytest.mark.parametrize("aa,rotation", [(True, 0.0), (False, 0.0), (True, 0.7)],
                         ids=["aa", "aliased", "rotated"])
def test_shape_equals_jax(kind, fill, aa, rotation):
    got, want = _raster_pair(_placed(kind, fill, aa, rotation))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(jshapes.ShapeKind), ids=lambda k: k.value)
def test_sdf_equals_jax(kind):
    """shape_sdf itself on a grid around the shape, and the signs of
    tests/test_shapes.py (inside negative, far outside positive)."""
    rng = np.random.default_rng(4)
    px = (rng.random((33, 41), np.float32) - 0.5) * 120.0
    py = (rng.random((33, 41), np.float32) - 0.5) * 120.0
    for hx, hy, r in ((40.0, 40.0, 5.0), (31.5, 12.25, 20.0), (3.0, 50.0, 0.0)):
        want = jshapes.shape_sdf(kind, px, py, hx, hy, r)
        got = tshapes.shape_sdf(tshapes.ShapeKind(kind.value), torch.from_numpy(px),
                                torch.from_numpy(py), hx, hy, r)
        np.testing.assert_array_equal(got.numpy(), want)
    if kind not in (jshapes.ShapeKind.STAR5, jshapes.ShapeKind.STAR6):
        probe = {jshapes.ShapeKind.RIGHT_TRIANGLE: (-20.0, 20.0),
                 jshapes.ShapeKind.CHECK: (-16.0, 12.0)}.get(kind, (0.0, 0.0))
        inside = tshapes.shape_sdf(kind, torch.tensor([probe[0]]), torch.tensor([probe[1]]),
                                   40.0, 40.0, 5.0)
        outside = tshapes.shape_sdf(kind, torch.tensor([100.0]), torch.tensor([100.0]),
                                    40.0, 40.0, 5.0)
        assert float(inside[0]) < 0 < float(outside[0])


@pytest.mark.parametrize("corner", [0.0, 4.0, 12.0, 100.0])
@pytest.mark.parametrize("fill", list(jshapes.ShapeFillMode), ids=lambda f: f.value)
def test_rounded_rect_corner_radius_equals_jax(corner, fill):
    got, want = _raster_pair(_placed(jshapes.ShapeKind.ROUNDED_RECT, fill, corner=corner,
                                     rotation=0.3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", [
    dict(cx=0.0, cy=0.0, hw=30.0, hh=20.0),      # over the top-left corner
    dict(cx=95.0, cy=71.0, hw=30.0, hh=20.0),    # over the bottom-right corner
    dict(cx=-200.0, cy=30.0, hw=10.0, hh=10.0),  # wholly off the canvas
    dict(cx=48.0, cy=36.0, hw=0.5, hh=0.5, outline_width=0.0),
    dict(cx=48.0, cy=36.0, hw=200.0, hh=150.0, rotation=3.9),
], ids=["top-left", "bottom-right", "off-canvas", "tiny", "oversized"])
@pytest.mark.parametrize("kind", [jshapes.ShapeKind.ELLIPSE, jshapes.ShapeKind.STAR6,
                                  jshapes.ShapeKind.ARROW, jshapes.ShapeKind.HEART],
                         ids=lambda k: k.value)
def test_shape_at_edges_equals_jax(spec, kind):
    got, want = _raster_pair(_placed(kind, jshapes.ShapeFillMode.BOTH, **spec))
    np.testing.assert_array_equal(got, want)
    buf, ox, oy = tshapes.rasterize_shape(
        tshapes.PlacedShape.from_jax(_placed(kind, jshapes.ShapeFillMode.BOTH, **spec)),
        W, H, device="cpu")
    jbuf, jox, joy = jshapes.rasterize_shape(_placed(kind, jshapes.ShapeFillMode.BOTH, **spec),
                                             W, H)
    assert (ox, oy) == (jox, joy)
    np.testing.assert_array_equal(buf.numpy(), jbuf)


# -- the SVG path parser ----------------------------------------------------------

PATHS = [
    "M 0 0 L 100 0 L 100 100 L 0 100 Z M 30 30 L 70 30 L 50 70 Z",
    "M 0 50 A 50 50 0 1 1 100 50 A 50 50 0 1 1 0 50 Z",
    "M 50 0 C 100 0 100 80 50 100 C 0 80 0 0 50 0 Z",
    "M10 10 C 20 0, 40 0, 50 10 S 80 20, 60 40 Q 50 60 30 50 T 10 40 A 12 8 30 1 0 10 10 Z "
    "m 5 5 h 10 v 10 l -10 0 z",
    "m10 10 c10-10 30-10 40 0s30 10 10 30q-10 20-30 10t-20-10a12 8 30 1 0 0-30z",
    "M0 0 a1 1 0 011 0 z",
    "M10 10 A5 5 0 10-3 4",
    "M 0 0 H 100 V 100 H 0 Z",
    "M 5 5 L 40 5 L 40 40 Z L 60 60 L 5 60",
    "M1e1 2E1 L .5 -.5e1 L+30 20",
    "M 0 0 A 0 10 0 0 1 20 20 L 0 20 Z",
]


@pytest.mark.parametrize("d", PATHS)
def test_svg_path_parser_equals_jax(d):
    jb = [float("inf"), float("inf"), float("-inf"), float("-inf")]
    tb = list(jb)
    assert tshapes.parse_svg_path(d, bbox_out=tb) == jshapes.parse_svg_path(d, bbox_out=jb)
    assert tb == jb
    assert list(tshapes._svg_tokens(d)) == list(jshapes._svg_tokens(d))
    try:
        want = jshapes.parse_custom_shape("n", "c", d)
    except jshapes.SvgPathError as e:
        with pytest.raises(tshapes.SvgPathError, match=str(e)[:20]):
            tshapes.parse_custom_shape("n", "c", d)
        return
    got = tshapes.parse_custom_shape("n", "c", d)
    assert (got.polylines, got.bounds, got.svg_path_data) == \
        (want.polylines, want.bounds, want.svg_path_data)


@pytest.mark.parametrize("d", ["M 5 5", "", "L 3 3", "M 1 2 L 3", "M 0 0 X 1 1",
                               "M 0 0 L 0 10 L 0 20 Z"])
def test_svg_path_errors_equal_jax(d):
    """No drawable geometry, a path not starting with a command, a short
    operand list, an unknown command letter (skipped), empty bounds: the
    same SvgPathError message or the same shape."""
    try:
        want = jshapes.parse_custom_shape("x", "t", d)
    except jshapes.SvgPathError as e:
        with pytest.raises(tshapes.SvgPathError) as got:
            tshapes.parse_custom_shape("x", "t", d)
        assert str(got.value) == str(e)
        return
    got = tshapes.parse_custom_shape("x", "t", d)
    assert (got.polylines, got.bounds) == (want.polylines, want.bounds)


def test_extract_svg_path_data_equals_jax():
    svg = '<svg><path fill="r" d="M0 0 L10 0 Z"/><path d=\'M20 20 L30 20\'/></svg>'
    assert tshapes.extract_svg_path_data(svg) == jshapes.extract_svg_path_data(svg) == \
        "M0 0 L10 0 Z M20 20 L30 20"
    for bad in ('<svg><image href="x"/></svg>', "<svg></svg>", '<path d="data:image/png"/>'):
        with pytest.raises(jshapes.SvgPathError) as want:
            jshapes.extract_svg_path_data(bad)
        with pytest.raises(tshapes.SvgPathError) as got:
            tshapes.extract_svg_path_data(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("d", [PATHS[0], PATHS[1], PATHS[3], PATHS[7]])
@pytest.mark.parametrize("fill", list(jshapes.ShapeFillMode), ids=lambda f: f.value)
@pytest.mark.parametrize("rotation", [0.0, 0.4])
def test_custom_shape_equals_jax(d, fill, rotation):
    data = jshapes.parse_custom_shape("c", "t", d)
    got, want = _raster_pair(_placed(jshapes.ShapeKind.RECTANGLE, fill, rotation=rotation,
                                     custom=data, outline_width=2.0))
    np.testing.assert_array_equal(got, want)


def test_custom_shape_cases_of_the_jax_tests():
    """tests/test_shapes.py: the even-odd hole, the outline mode."""
    cs = jshapes.parse_custom_shape("notch", "test", PATHS[0])
    ps = jshapes.PlacedShape(cx=64, cy=64, hw=40, hh=40,
                             fill_mode=jshapes.ShapeFillMode.FILLED, custom_shape_data=cs,
                             primary_color=(255, 0, 0, 255))
    img, want = _raster_pair(ps, 128, 128)
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(img[64, 64], [0, 0, 0, 0])
    np.testing.assert_array_equal(img[30, 30], [255, 0, 0, 255])
    sq = jshapes.parse_custom_shape("sq", "t", PATHS[7])
    ps = jshapes.PlacedShape(cx=64, cy=64, hw=40, hh=40,
                             fill_mode=jshapes.ShapeFillMode.OUTLINE, outline_width=2.0,
                             custom_shape_data=sq, primary_color=(0, 255, 0, 255))
    img, want = _raster_pair(ps, 128, 128)
    np.testing.assert_array_equal(img, want)
    assert img[24, 64, 3] > 0 and img[64, 64, 3] == 0


@pytest.mark.parametrize("d", [PATHS[0], PATHS[1], PATHS[2], PATHS[3]])
@pytest.mark.parametrize("size,dark", [(24, True), (40, False), (7, True)])
def test_custom_shape_icon_equals_jax(d, size, dark):
    data = jshapes.parse_custom_shape("i", "t", d)
    got = tshapes.render_custom_shape_icon(tshapes.CustomShapeData.from_jax(data), size, dark,
                                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), jshapes.render_custom_shape_icon(data, size, dark))


def test_coverage_blocks_do_not_change_the_result(monkeypatch):
    """custom_shape_coverage takes the pixels a block of rows at a time:
    one-row blocks give the same coverage."""
    data = jshapes.parse_custom_shape("c", "t", PATHS[3])
    placed = _placed(jshapes.ShapeKind.RECTANGLE, jshapes.ShapeFillMode.BOTH, custom=data)
    whole, _ = _raster_pair(placed)
    monkeypatch.setattr(tshapes, "_BLOCK", 1)
    rows, want = _raster_pair(placed)
    np.testing.assert_array_equal(rows, whole)
    np.testing.assert_array_equal(rows, want)


def test_shape_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    placed = tshapes.PlacedShape(10.0, 10.0, 5.0, 5.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tshapes.rasterize_shape(placed, 20, 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        tshapes.rasterize_to_canvas(placed, 20, 20)
