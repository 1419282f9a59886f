"""The port on the cases of tests/test_review_r5_parity.py: host-fn arity
errors in every script tier and in the traced batch path, canvas ops that
pad stale layer masks, cut, merge_down of a text layer, duplicate naming,
text effects, the SVG parser, flood tolerance, the device layer cache's
view of a mask bake, strict int typing and for_region's u32 wrap.  Each
case builds the same state in both packages and holds the port's result
(device="cpu") to the JAX package's at tolerance 0, besides the JAX test's
own expectation."""

import importlib
import inspect
import types

import numpy as np
import pytest

import paintfe_tpu
import paintfe_tpu_torch


def package(root):
    name = root.__name__
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    canvas = mod("core.canvas")
    return types.SimpleNamespace(
        Canvas=canvas.Canvas, Layer=canvas.Layer, scripting=mod("scripting"),
        api=mod("scripting.api"), engine=mod("scripting.engine"),
        interp=mod("scripting.interp"), pipeline=mod("parallel.pipeline"),
        selection=mod("core.selection"), clipboard=mod("ops.clipboard"),
        canvas_ops=mod("ops.canvas_ops"), text=mod("ops.text_layer"),
        shapes=mod("ops.shapes"), color_removal=mod("ops.color_removal"),
        device=mod("core.device"), port=root is paintfe_tpu_torch)


J, T = package(paintfe_tpu), package(paintfe_tpu_torch)


def dev(p):
    """The device keyword of a port entry point: the CPU here."""
    return {"device": "cpu"} if p.port else {}


def run(p, src, px, w, h):
    """`src` through `p`'s engine: ("ok", pixels, console) or ("err", message)."""
    try:
        out, _w, _h, console, _ops = p.scripting.execute_script_sync(src, px.copy(), w, h, None,
                                                                     **dev(p))
    except p.scripting.ScriptError as e:
        return ("err", e.message)
    return ("ok", np.asarray(out).tobytes(), console)


def both(src, px):
    h, w = px.shape[:2]
    out = run(T, src, px, w, h)
    assert out == run(J, src, px, w, h)
    return out


def flat(p, c):
    return np.asarray(c.composite(**dev(p)))


@pytest.mark.parametrize("mode", ["0", "1"])
def test_host_arity_errors_are_script_errors(mode, monkeypatch):
    monkeypatch.setenv("PAINTFE_SCRIPT_COMPILE", mode)
    px = np.zeros((4, 4, 4), np.uint8)
    for src in ("apply_levels(0.0, 255.0);", "apply_blur();"):
        out = both(src, px)
        assert out[0] == "err" and "function not found" in out[1]
    assert both('try { apply_blur(); } catch (e) { print_line("caught"); }', px)[2] == ["caught"]
    assert both("apply_sepia();", px)[0] == "ok"


def test_trace_path_arity_matches_interpreter():
    def messages(p):
        out = []
        for src in ("apply_levels(0.0, 255.0);", "apply_blur(1.0, 2.0);"):
            with pytest.raises(p.interp.RhaiRuntimeError, match="function not found") as ei:
                p.pipeline.trace_script(src)
            out.append(ei.value.message)
        return out, [op.name for op in p.pipeline.trace_script("apply_sepia();")]

    got = messages(T)
    assert got == messages(J)
    assert got[1] == ["apply_sepia"]


def test_canvas_ops_pad_stale_layer_masks():
    def replay(p):
        c = p.Canvas.new(8, 6, (10, 10, 10, 255))
        c.layers.append(p.Layer.new("top", 8, 6, (200, 0, 0, 255)))
        c.layers[1].mask = np.full((6, 8), 255, np.uint8)
        c.layers[1].mask_enabled = True
        p.engine.apply_canvas_ops(c, [p.api.CanvasOpRequest(
            kind="resize_image", w=12, h=10, filter="nearest")], skip_layer=-1)
        return c, flat(p, c)

    c, out = replay(T)
    jc, jout = replay(J)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(c.layers[1].mask, jc.layers[1].mask)
    assert c.layers[1].mask.shape == (10, 12)
    assert out.shape == (10, 12, 4)
    assert c.layers[1].mask[:6, :8].min() == 255
    assert c.layers[1].mask[6:, :].max() == 0


def test_cut_auto_deselects():
    def cut(p):
        c = p.Canvas.new(8, 8, (50, 60, 70, 255))
        c.selection = np.asarray(p.selection.rect_mask(8, 8, 2, 2, 4, 4))
        cb = p.clipboard.Clipboard()
        cb.cut(c)
        return c, cb

    c, cb = cut(T)
    jc, jcb = cut(J)
    assert c.selection is None and jc.selection is None
    np.testing.assert_array_equal(c.layers[0].pixels, np.asarray(jc.layers[0].pixels))
    np.testing.assert_array_equal(cb.image, np.asarray(jcb.image))
    assert cb.origin == jcb.origin


def test_merge_down_rasterizes_text():
    def merged(p):
        c = p.Canvas.new(64, 32, (255, 255, 255, 255))
        top = p.Layer.new("text", 64, 32, (0, 0, 0, 0))
        top.content = "text"
        top.text_data = p.text.make_text_layer_data("Hi", 4, 4, size=16, color=(255, 0, 0, 255))
        c.layers.append(top)
        p.canvas_ops.merge_down(c, 1, **dev(p))
        return c

    c, jc = merged(T), merged(J)
    assert len(c.layers) == len(jc.layers) == 1
    survivor = c.layers[0]
    assert survivor.content == jc.layers[0].content == "raster"
    assert survivor.text_data is None
    np.testing.assert_array_equal(survivor.pixels, np.asarray(jc.layers[0].pixels))
    assert (survivor.pixels[..., 1] < 250).any()


def test_duplicate_layer_name_capital_copy():
    def dup(p):
        c = p.Canvas.new(4, 4, (1, 2, 3, 255))
        p.canvas_ops.duplicate_layer(c, 0)
        return [layer.name for layer in c.layers], c

    names, c = dup(T)
    assert names == dup(J)[0]
    assert c.layers[1].name == f"{c.layers[0].name} Copy"


def test_outline_derives_from_text_not_shadow():
    rgba = np.zeros((40, 80, 4), np.uint8)
    rgba[8:16, 8:24] = [255, 0, 0, 255]

    def effects(p):
        t = p.text
        fx = t.TextEffects(
            outline=t.OutlineEffect(width=2, color=(0, 255, 0, 255),
                                    position=t.OutlinePosition.OUTSIDE),
            shadow=t.ShadowEffect(offset_x=30, offset_y=18, blur_radius=2.0,
                                  color=(0, 0, 255, 255)))
        return np.asarray(t._apply_effects(rgba.copy(), fx, **dev(p)))

    out = effects(T)
    np.testing.assert_array_equal(out, effects(J))
    region = out[24:36, 36:56]
    assert region[..., 3].max() > 0
    green_ring = (region[..., 1].astype(int) > 128) & (region[..., 2] < 100)
    assert not green_ring.any(), "outline traced the shadow blob"
    ring_zone = out[5:19, 5:27]
    assert ((ring_zone[..., 1].astype(int) > 128) & (ring_zone[..., 0] < 100)).any()


def test_svg_subpath_after_z_keeps_closepoint():
    polys = T.shapes.parse_svg_path("M0 0 H10 V10 Z L20 20 L30 30")
    assert polys == J.shapes.parse_svg_path("M0 0 H10 V10 Z L20 20 L30 30")
    assert len(polys) == 2
    assert polys[1][0] == (0.0, 0.0)
    assert polys[1][1] == (20.0, 20.0)


def test_custom_shape_bbox_includes_curve_extrema():
    shape = T.shapes.parse_custom_shape("b", "t", "M0 0 Q 50 -100 100 0")
    assert shape.bounds == J.shapes.parse_custom_shape("b", "t", "M0 0 Q 50 -100 100 0").bounds
    x0, y0, x1, y1 = shape.bounds
    assert y0 <= -49.9, shape.bounds
    assert x0 == 0.0 and x1 == 100.0


def test_flood_tolerance_f32_chain():
    tol = 0.09
    assert np.float32(tol) * np.float32(2.55) != np.float32(tol * 2.55)
    px = np.zeros((1, 2, 4), np.uint8)
    px[0, 0] = [10, 0, 0, 255]
    px[0, 1] = [11, 0, 0, 255]
    m = T.color_removal.flood_select(px, 0, 0, tolerance=tol, contiguous=False, device="cpu")
    np.testing.assert_array_equal(m, np.asarray(J.color_removal.flood_select(
        px, 0, 0, tolerance=tol, contiguous=False)))
    assert m[0, 1] == 0 and m[0, 0] == 255
    assert "f32(tolerance) * f32(2.55)" in inspect.getsource(T.color_removal.flood_select)


def test_device_cache_sees_layer_mask_bake():
    def bake(p):
        c = p.Canvas.new(8, 8, (100, 100, 100, 255))
        c.layers[0].mask = np.full((8, 8), 255, np.uint8)
        cache = p.device.DeviceLayerCache(**dev(p))
        before = np.asarray(cache.get(c.layers[0]))
        p.canvas_ops.apply_layer_mask(c, 0)
        return before, np.asarray(cache.get(c.layers[0]))

    before, after = bake(T)
    jbefore, jafter = bake(J)
    np.testing.assert_array_equal(before, jbefore)
    np.testing.assert_array_equal(after, jafter)
    assert before[..., 3].min() == 255
    assert after[..., 3].max() == 0, "cache served the stale upload"


def test_script_rotate_drops_selection_mask():
    out = both("select_rect(0, 0, 3, 3); rotate_canvas_90cw(); "
               "fill_selected(255, 0, 0, 255); print_line(`${has_selection()}`);",
               np.zeros((4, 8, 4), np.uint8))
    assert out[2] == ["false"]


@pytest.mark.parametrize("src,fails", [
    ("get_pixel(1.0, 2);", True),
    ("apply_median(2.0);", True),
    ("apply_median(2);", False),
])
def test_strict_int_typing(src, fails):
    out = both(src, np.zeros((4, 4, 4), np.uint8))
    assert (out[0] == "err") == fails
    if fails:
        assert "integer" in out[1]


def test_for_region_origin_u32_wrap():
    px = np.zeros((4, 16, 4), np.uint8)
    out = both("let n = 0; for_region(4294967296, 0, 10, 4, "
               "|x, y, r, g, b, a| { n += 1; [255, g, b, 255] }); print_line(`${n}`);", px)
    assert out[2] == [f"{10 * 4}"]
    img = np.frombuffer(out[1], np.uint8).reshape(4, 16, 4)
    assert (img[:, :10, 0] == 255).all() and (img[:, 10:, 0] == 0).all()


def test_warped_glyphs_land_on_anchor():
    def raster(p):
        t = p.text
        td = t.TextLayerData()
        td.add_block(t.TextBlock(position=(40.0, 40.0), rotation=np.pi / 2, runs=[
            t.TextRun(text="I", style=t.TextStyle(font_size=20, color=(0, 0, 0, 255)))]))
        return np.asarray(td.rasterize(96, 96, **dev(p)))

    img = raster(T)
    np.testing.assert_array_equal(img, raster(J))
    ys, xs = np.nonzero(img[..., 3])
    assert len(ys) > 0
    cx, cy = xs.mean(), ys.mean()
    assert abs(cx - 40) < 22 and abs(cy - 40) < 22, (cx, cy)
