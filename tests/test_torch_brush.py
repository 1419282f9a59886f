"""The port's brush, brush tips, clone and heal (paintfe_tpu_torch.tools) on
the CPU against the JAX package's paintfe_tpu.tools, tolerance 0: every
case of tests/test_tools.py compared with the JAX function's output on the
same input instead of a golden, every brush mode with and without AA, the
eraser, scatter and jitter, selections and the canvas edges; the tip
registry, tip rebuilds and image-tip stamps (rotation, scatter, eraser,
the stock tips); the stamp hash on negative coordinates; the clone and heal
cases of tests/test_vector_tools.py and tests/test_tools.py.  Inputs are
numpy-seeded; a target is a u8 tensor on the CPU, written in place."""

import io

import numpy as np
import pytest
import torch

from paintfe_tpu.core import fixtures
from paintfe_tpu.tools import brush as jbrush
from paintfe_tpu.tools import brush_tips as jtips
from paintfe_tpu.tools import clone_heal as jclone
from paintfe_tpu_torch.tools import Brush, BrushMode
from paintfe_tpu_torch.tools import brush_tips as ttips
from paintfe_tpu_torch.tools import clone_heal as tclone

W = H = 64
WHITE = (1.0, 1.0, 1.0, 1.0)
BLACK = (0.0, 0.0, 0.0, 1.0)
RED = (1.0, 0.0, 0.0, 1.0)
BLUE_SEMI = (0.0, 0.0, 1.0, 0.5)


def _blank():
    return np.zeros((H, W, 4), np.uint8)


def _white():
    return np.full((H, W, 4), 255, np.uint8)


def _gradient():
    return np.asarray(fixtures.test_gradient(W, H))


def _left_half():
    mask = np.zeros((H, W), np.uint8)
    mask[:, : W // 2] = 255
    return mask


def _stroke8(b, img):
    for i in range(8):
        b.draw_circle(img, (8.0 + i * 7.0, 32.0), primary=BLACK)


# name -> (image, brush args, brush kwargs, draw(brush, img)); the cases of
# tests/test_tools.py
TOOL_CASES = {
    "brush_circle_center": (_blank, (20.0, 1.0, True), {},
                            lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK,
                                                       secondary=WHITE)),
    "brush_circle_soft": (_blank, (30.0, 0.0, True), {},
                          lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK,
                                                     secondary=WHITE)),
    "brush_circle_hard": (_blank, (20.0, 1.0, False), {},
                          lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK,
                                                     secondary=WHITE)),
    "brush_circle_tiny": (_blank, (3.0, 1.0, True), {},
                          lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=RED,
                                                     secondary=WHITE)),
    "brush_circle_large": (_blank, (60.0, 0.5, True), {},
                           lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK,
                                                      secondary=WHITE)),
    "brush_semi_transparent": (_blank, (20.0, 1.0, True), {},
                               lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLUE_SEMI,
                                                          secondary=WHITE)),
    "brush_secondary_color": (_blank, (20.0, 1.0, True), {},
                              lambda b, i: b.draw_circle(i, (32.0, 32.0), use_secondary=True,
                                                         primary=BLACK, secondary=RED)),
    "eraser_circle": (_white, (20.0, 1.0, True), {},
                      lambda b, i: b.draw_circle(i, (32.0, 32.0), is_eraser=True,
                                                 primary=BLACK, secondary=WHITE)),
    "eraser_soft": (_white, (30.0, 0.0, True), {},
                    lambda b, i: b.draw_circle(i, (32.0, 32.0), is_eraser=True,
                                               primary=BLACK, secondary=WHITE)),
    "line_horizontal": (_blank, (8.0, 1.0, True), {},
                        lambda b, i: b.draw_line(i, (4.0, 32.0), (60.0, 32.0), primary=BLACK)),
    "line_vertical": (_blank, (8.0, 1.0, True), {},
                      lambda b, i: b.draw_line(i, (32.0, 4.0), (32.0, 60.0), primary=BLACK)),
    "line_diagonal": (_blank, (6.0, 0.8, True), {},
                      lambda b, i: b.draw_line(i, (4.0, 4.0), (60.0, 60.0), primary=BLACK)),
    "line_soft_thick": (_blank, (16.0, 0.3, True), {},
                        lambda b, i: b.draw_line(i, (10.0, 50.0), (54.0, 10.0), primary=RED)),
    "line_eraser": (_white, (10.0, 1.0, True), {},
                    lambda b, i: b.draw_line(i, (4.0, 32.0), (60.0, 32.0), is_eraser=True,
                                             primary=BLACK)),
    "brush_with_selection_mask": (_blank, (40.0, 1.0, True), {},
                                  lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK,
                                                             mask=_left_half())),
    "stroke_multiple_stamps": (_blank, (10.0, 0.8, True), {}, _stroke8),
    "brush_at_origin": (_blank, (10.0, 1.0, True), {},
                        lambda b, i: b.draw_circle(i, (0.0, 0.0), primary=BLACK)),
    "brush_at_corner": (_blank, (20.0, 1.0, True), {},
                        lambda b, i: b.draw_circle(i, (63.0, 63.0), primary=BLACK)),
    "line_zero_length": (_blank, (12.0, 1.0, True), {},
                         lambda b, i: b.draw_line(i, (32.0, 32.0), (32.0, 32.0), primary=BLACK)),
    "brush_dodge_mode": (_gradient, (24.0, 1.0, True), {"brush_mode": "DODGE"},
                         lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK)),
    "brush_burn_mode": (_gradient, (24.0, 1.0, True), {"brush_mode": "BURN"},
                        lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK)),
    "pencil_circle": (_blank, (12.0, 1.0, False), {},
                      lambda b, i: b.draw_circle(i, (32.0, 32.0), primary=BLACK)),
    "pencil_line": (_blank, (4.0, 1.0, False), {},
                    lambda b, i: b.draw_line(i, (4.0, 4.0), (60.0, 60.0), primary=RED)),
    "color_picker_reads_painted_pixel": (_blank, (10.0, 1.0, True), {},
                                         lambda b, i: b.draw_circle(i, (32.0, 32.0),
                                                                    primary=RED)),
}


def _brushes(args, kwargs):
    mode = kwargs.get("brush_mode", "NORMAL")
    return (jbrush.Brush(*args, brush_mode=jbrush.BrushMode[mode]),
            Brush(*args, brush_mode=BrushMode[mode]))


def _both(make, draw_j, draw_t):
    want = make()
    got = torch.from_numpy(want.copy())
    draw_j(want)
    draw_t(got)
    return got.numpy(), want


@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_tool_case_equals_jax(case):
    make, args, kwargs, draw = TOOL_CASES[case]
    jb, tb = _brushes(args, kwargs)
    got, want = _both(make, lambda i: draw(jb, i), lambda i: draw(tb, i))
    np.testing.assert_array_equal(got, want)
    assert tb.stamp_counter == jb.stamp_counter
    if case == "color_picker_reads_painted_pixel":
        assert tuple(got[32, 32]) == (255, 0, 0, 255)


@pytest.mark.parametrize("mode", ["NORMAL", "DODGE", "BURN", "SPONGE"])
@pytest.mark.parametrize("aa", [True, False], ids=["aa", "aliased"])
@pytest.mark.parametrize("eraser", [False, True], ids=["paint", "erase"])
@pytest.mark.parametrize("props", [{}, {"scatter": 0.5},
                                   {"hue_jitter": 0.7, "brightness_jitter": 0.4}],
                         ids=["plain", "scatter", "jitter"])
def test_brush_line_every_mode_equals_jax(mode, aa, eraser, props):
    """A line across a gradient under a selection, off the bottom-right
    corner: each mode, AA or not, paint or erase, scatter and jitter."""
    jb, tb = _brushes((17.0, 0.3, aa), {"brush_mode": mode})
    for b in (jb, tb):
        for k, v in props.items():
            setattr(b.properties, k, v)
    mask = np.zeros((H, W), np.uint8)
    mask[:, :40] = 255
    kw = dict(is_eraser=eraser, primary=(0.8, 0.3, 0.2, 0.9), mask=mask)
    got, want = _both(_gradient, lambda i: jb.draw_line(i, (3.0, 5.0), (70.0, 66.0), **kw),
                      lambda i: tb.draw_line(i, (3.0, 5.0), (70.0, 66.0), **kw))
    np.testing.assert_array_equal(got, want)
    assert tb.stamp_counter == jb.stamp_counter


def test_brush_lut_and_alpha_equal_jax():
    """The 256-entry LUT (compute_brush_alpha on a CPU tensor) and
    compute_brush_alpha on a tensor; the LUT also over sizes that are not
    f32-exact halves, each hardness and AA or not."""
    sizes = np.random.default_rng(7).uniform(0.5, 300.0, 60)
    for args in [(float(s), hard, aa) for s in sizes for hard in (0.0, 0.37, 1.0)
                 for aa in (True, False)]:
        jb, tb = _brushes(args, {})
        np.testing.assert_array_equal(tb._lut, jb._lut)
    for args in ((20.0, 1.0, True), (7.0, 0.3, False), (0.001, 0.5, True), (33.0, 0.0, True)):
        jb, tb = _brushes(args, {})
        np.testing.assert_array_equal(tb._lut, jb._lut)
        dist = np.random.default_rng(1).random(300, np.float32) * args[0]
        want = jb.compute_brush_alpha(dist, np.float32(args[0] / 2))
        got = tb.compute_brush_alpha(torch.from_numpy(dist), np.float32(args[0] / 2))
        np.testing.assert_array_equal(got.numpy(), want)


def test_brush_state_carries_across():
    jb = jbrush.Brush(14.0, 0.6, False, brush_mode=jbrush.BrushMode.SPONGE)
    jb.properties.scatter = 0.3
    img = np.zeros((H, W, 4), np.uint8)
    jb.draw_line(img, (5.0, 5.0), (30.0, 9.0))
    tb = Brush.from_jax(jb)
    assert tb.stamp_counter == jb.stamp_counter
    assert tb.properties.brush_mode == BrushMode.SPONGE and tb.properties.scatter == 0.3
    got, want = _both(_gradient, lambda i: jb.draw_line(i, (40.0, 5.0), (20.0, 50.0)),
                      lambda i: tb.draw_line(i, (40.0, 5.0), (20.0, 50.0)))
    np.testing.assert_array_equal(got, want)


def test_brush_refuses_a_host_target():
    with pytest.raises(TypeError, match="tensor"):
        Brush(10.0).draw_circle(np.zeros((8, 8, 4), np.uint8), (4.0, 4.0))


# -- image brush tips ----------------------------------------------------------


def _tip_png(pattern="disc", size=64):
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    d = np.hypot(xx - size / 2, yy - size / 2)
    if pattern == "disc":
        img = np.where(d < size * 0.4, 255, 0).astype(np.uint8)
    else:  # soft radial
        img = np.clip(255.0 * (1.0 - d / (size * 0.5)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, "PNG")
    return buf.getvalue()


def test_tip_library_equals_jax():
    from PIL import Image

    jlib, tlib = jtips.BrushTipLibrary(), ttips.BrushTipLibrary()
    rect = io.BytesIO()
    Image.fromarray(np.full((16, 40), 200, np.uint8), "L").save(rect, "PNG")
    for name, cat, data in (("disc", "custom", _tip_png()), ("rect", "custom", rect.getvalue()),
                            ("disc", "other", _tip_png("soft"))):
        jt, tt = jlib.load_brush_tip(name, cat, data), tlib.load_brush_tip(name, cat, data)
        assert tt.mask_size == jt.mask_size
        np.testing.assert_array_equal(tt.mask, jt.mask)
        assert tlib.categories == jlib.categories
    assert tlib.remove_brush_tip("rect") and jlib.remove_brush_tip("rect")
    assert tlib.get("rect") is None and tlib.categories == jlib.categories
    assert not tlib.remove_brush_tip("rect")
    tip = ttips.BrushTipData.from_jax(jlib.get("disc"))
    np.testing.assert_array_equal(tip.mask, jlib.get("disc").mask)


@pytest.mark.parametrize("size", [3.0, 24.0, 32.0, 128.0, 7.5])
@pytest.mark.parametrize("hardness", [1.0, 0.2, 0.8])
def test_rebuild_tip_mask_equals_jax(size, hardness):
    tip = jtips.BrushTipLibrary().load_brush_tip("soft", "c", _tip_png("soft"))
    np.testing.assert_array_equal(
        ttips.rebuild_tip_mask(ttips.BrushTipData.from_jax(tip), size, hardness),
        jtips.rebuild_tip_mask(tip, size, hardness))


@pytest.mark.parametrize("rotation", [0.0, 30.0, -75.0, 180.0])
@pytest.mark.parametrize("eraser", [False, True], ids=["paint", "erase"])
@pytest.mark.parametrize("scatter", [0.0, 0.5])
def test_draw_image_tip_equals_jax(rotation, eraser, scatter):
    """Three stamps (one at the centre, two across the edges) of a disc tip
    under a selection, on a noisy target."""
    tip = jtips.BrushTipLibrary().load_brush_tip("disc", "c", _tip_png())
    mask = jtips.rebuild_tip_mask(tip, 24.0, 1.0)
    sel = np.zeros((48, 48), np.uint8)
    sel[:, 10:] = 255

    def stamps(draw, target, m):
        for k, pos in enumerate([(24.3, 20.8), (2.0, 45.0), (46.0, 3.0)]):
            draw(target, pos, m, (200, 40, 30, 230), is_eraser=eraser, flow=0.8,
                 rotation_deg=rotation, scatter=scatter, stamp_counter=k + 5,
                 brush_size=24, selection=sel)

    rng = np.random.default_rng(2)
    got, want = _both(lambda: rng.integers(0, 256, (48, 48, 4), np.uint8),
                      lambda i: stamps(jtips.draw_image_tip, i, mask),
                      lambda i: stamps(ttips.draw_image_tip, i, torch.from_numpy(mask)))
    np.testing.assert_array_equal(got, want)


def test_stock_tips_equal_jax():
    """The 13 procedural stock tips: registry, masks, a rebuild and a
    rotated stamp of each."""
    jlib, tlib = jtips.stock_library(), ttips.stock_library()
    assert tlib.categories == jlib.categories
    assert list(tlib.categories) == ["Artistic", "Basic", "Texture", "Vegetation"]
    for name, jt in jlib.tips.items():
        tt = tlib.tips[name]
        assert (tt.name, tt.category, tt.mask_size) == (jt.name, jt.category, jt.mask_size)
        np.testing.assert_array_equal(tt.mask, jt.mask)
        m = jtips.rebuild_tip_mask(jt, 24.0, 0.8)
        np.testing.assert_array_equal(ttips.rebuild_tip_mask(tt, 24.0, 0.8), m)
        got, want = _both(lambda: np.zeros((48, 48, 4), np.uint8),
                          lambda i: jtips.draw_image_tip(i, (24.0, 24.0), m, (255, 0, 0, 255),
                                                         rotation_deg=30.0),
                          lambda i: ttips.draw_image_tip(i, (24.0, 24.0), m, (255, 0, 0, 255),
                                                         rotation_deg=30.0))
        np.testing.assert_array_equal(got, want)
        assert (got[..., 3] > 0).any(), name


@pytest.mark.parametrize("pos", [(10.0, 12.0), (-3.5, 7.25), (1e9, -1e9), (0.0, 0.0)])
@pytest.mark.parametrize("counter", [0, 7, 0xFFFFFFFF])
def test_stamp_hash_and_jitter_equal_jax(pos, counter):
    """The wrapping hash (negative coordinates saturate to 0, as Rust's
    `as u32`), its unit value and the HSL colour jitter."""
    assert ttips.stamp_hash(*pos, counter) == jtips.stamp_hash(*pos, counter)
    assert ttips.hash_unit(*pos, counter) == jtips.hash_unit(*pos, counter)
    for hue, bright in ((0.5, 0.3), (0.0, 0.0), (0.9, 0.0), (0.0, 0.8)):
        assert ttips.jitter_color((200, 40, 40), hue, bright, pos, counter) == \
            jtips.jitter_color((200, 40, 40), hue, bright, pos, counter)
        assert ttips.jitter_color_unit((0.8, 0.3, 0.1), hue, bright, pos, counter) == \
            jtips.jitter_color_unit((0.8, 0.3, 0.1), hue, bright, pos, counter)
    assert ttips.stamp_hash(-1.0, 5.0, 3) == ttips.stamp_hash(-123.0, 5.0, 3) == \
        ttips.stamp_hash(0.0, 5.0, 3)


# -- clone and heal --------------------------------------------------------------


def _source():
    return _gradient()


CLONE_CASES = {
    # tests/test_vector_tools.py
    "samples_offset_source": lambda ch, b, p, s: ch.clone_stamp_circle(
        b(12.0, 0.8), p, s, (40, 40), (-20.0, -20.0)),
    "respects_selection": lambda ch, b, p, s: ch.clone_stamp_circle(
        b(12.0, 1.0), p, s, (40, 40), (0.0, 0.0), selection=_right_of(40)),
    "offset_off_canvas": lambda ch, b, p, s: ch.clone_stamp_circle(
        b(12.0, 1.0), p, s, (3, 3), (-100.0, -100.0)),
    "heal_averages_surroundings": lambda ch, b, p, s: ch.heal_line(
        b(12.0, 0.8), p, _marred(s), (30, 30), (34, 34), sample_radius=10.0),
    # tests/test_tools.py
    "line_skips_offcanvas_steps": lambda ch, b, p, s: ch.clone_stamp_line(
        b(10.0, 1.0), p, s, (-6.0, 16.0), (-2.0, 16.0), (4.0, 0.0)),
    "heal_tap_off_canvas": lambda ch, b, p, s: ch.heal_line(
        b(10.0, 1.0), p, s, (-0.5, 16.0), (-0.5, 16.0), 4.0),
    "source_rounds_half_away": lambda ch, b, p, s: ch.clone_stamp_circle(
        b(3.0, 1.0, False), p, _telltale(s), (8.0, 8.0), (-8.5, 0.0)),
    # strokes across the canvas and its edges under a selection
    "clone_line_soft": lambda ch, b, p, s: ch.clone_stamp_line(
        b(23.0, 0.1), p, s, (3, 5), (70, 66), (-8.5, 4.5), _right_of(12)),
    "clone_line_aliased": lambda ch, b, p, s: ch.clone_stamp_line(
        b(7.0, 1.0, False), p, s, (60, 2), (1, 40), (6.5, -3.5), _right_of(12)),
    "heal_line_soft": lambda ch, b, p, s: ch.heal_line(
        b(23.0, 0.1), p, s, (-0.5, 5), (70, 60), 6.0, _right_of(12)),
    "heal_line_hard": lambda ch, b, p, s: ch.heal_line(
        b(9.0, 1.0), p, s, (60, 2), (5, 62), 11.0),
}


def _telltale(s):
    """A transparent source but for column 0: a source x of -0.5 must round
    to -1 (nothing cloned), not to column 0."""
    out = s.clone() if isinstance(s, torch.Tensor) else s.copy()
    out[...] = 0
    out[:, 0] = 9
    out[:, 0, 3] = 255
    return out


def _right_of(x):
    sel = np.zeros((H, W), np.uint8)
    sel[:, x:] = 255
    return sel


def _marred(s):
    out = s.clone() if isinstance(s, torch.Tensor) else s.copy()
    out[28:36, 28:36, 0:3] = 0
    return out


@pytest.mark.parametrize("case", list(CLONE_CASES))
def test_clone_heal_equals_jax(case):
    run = CLONE_CASES[case]
    src = _source()
    want = np.zeros((H, W, 4), np.uint8)
    got = torch.zeros((H, W, 4), dtype=torch.uint8)
    run(jclone, lambda *a: jbrush.Brush(*a), want, src)
    run(tclone, lambda *a: Brush(*a), got, torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "samples_offset_source":
        np.testing.assert_array_equal(got[40, 40, 0:3].numpy(), src[20, 20, 0:3])
    if case in ("offset_off_canvas", "line_skips_offcanvas_steps", "source_rounds_half_away"):
        assert not (got[..., 3] > 0).any()
    if case == "heal_tap_off_canvas":
        assert (got[..., 3] > 0).any()
