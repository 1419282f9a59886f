"""The port's script engine against the JAX package's: the copied front
end does not drift, and execute_script_sync gives the same pixels, dims,
console and canvas ops on the same seeded inputs (tolerance 0)."""

import pathlib

import numpy as np
import pytest

from paintfe_tpu.scripting import engine as jengine
from paintfe_tpu_torch.scripting import engine as tengine

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["rhai_ast.py", "interp.py", "pycompile.py"])
def test_front_end_copies_do_not_drift(name):
    jax_src = (ROOT / "paintfe_tpu" / "scripting" / name).read_text()
    port_src = (ROOT / "paintfe_tpu_torch" / "scripting" / name).read_text()
    assert port_src == jax_src.replace("paintfe_tpu.scripting",
                                       "paintfe_tpu_torch.scripting")


SCRIPTS = {
    "headline": ("apply_blur(2.0); apply_brightness_contrast(10.0, 20.0); "
                 "apply_levels(10.0, 245.0, 1.1); apply_sepia(0.5);"),
    "pure_closure": ("for_each_pixel(|x, y, r, g, b, a| "
                     "{ [r / 2, g, (b + x) % 256, a] });"),
    "impure_closure": ('let n = 0; for_each_pixel(|x, y, r, g, b, a| { '
                       'if x == 1 && y == 2 { print_line("px " + r); } '
                       '[255 - r, g, rand_int(0, 255), a] });'),
    "print_line": 'print_line("w=" + width() + " h=" + height()); print(3.5);',
    "selection": ("select_rect(2, 2, 10, 8); apply_blur(1.5); apply_invert(); "
                  "invert_selection(); apply_sepia(); clear_selection(); "
                  "flip_horizontal();"),
    "host_pointwise": ("apply_hsl(30.0, 10.0, -5.0); apply_exposure(0.5); "
                       "apply_desaturate(); apply_levels(5.0, 250.0, 0.8);"),
    "region_channels": ("for_region(3, 4, 8, 6, |x, y, r, g, b, a| { [g, r, b, a] }); "
                        "map_channels(|r, g, b, a| { [b, g, r, 200] });"),
    "canvas_ops": ("rotate_canvas_90cw(); flip_canvas_vertical(); "
                   "rotate_canvas_180(); apply_blur(1.0);"),
    "pixels": ("set_pixel(1, 1, 9, 8, 7, 6); let p = get_pixel(1, 1); "
               "print_line(`${p}`); fill_selected(1, 2, 3, 4);"),
    "median_bulge": "apply_median(2); apply_bulge(0.5);",
    "spatial_selection": ("select_ellipse(12, 9, 8, 6); apply_median(1); "
                          "apply_bulge(-0.4); invert_selection(); apply_median(3);"),
    "effects": ("apply_box_blur(2); apply_motion_blur(20.0, 3.0); apply_sharpen(1.0); "
                "apply_pixelate(2); apply_crystallize(4); apply_vignette(0.4, 0.7); "
                "apply_oil_painting(1); apply_noise(10.0, false);"),
    "effects_selection": ("select_rect(3, 2, 20, 14); apply_glow(2.0, 0.5); "
                          "apply_ink(30.0, 20.0); invert_selection(); apply_halftone(4.0); "
                          "apply_box_blur(1);"),
    "resize": ('resize_image(31, 23, "bicubic"); resize_canvas(40, 20, "br"); '
               'apply_blur(1.0); resize_image(12, 9, "nearest"); resize_canvas(9, 9);'),
}


def _run(engine, source, img, mask=None):
    h, w = img.shape[:2]
    # the port's entry points run on the card unless told otherwise
    kw = {"device": "cpu"} if engine is tengine else {}
    px, nw, nh, console, ops = engine.execute_script_sync(
        source, img, w, h, mask, rng_seed=1234, **kw)
    return (np.asarray(px), nw, nh, console,
            [(o.kind, o.w, o.h, o.filter, tuple(o.anchor)) for o in ops])


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_execute_script_sync_matches_jax(name):
    img = np.random.default_rng(21).integers(0, 256, (18, 26, 4), np.uint8)
    ref = _run(jengine, SCRIPTS[name], img)
    out = _run(tengine, SCRIPTS[name], img)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1:] == ref[1:]


def test_blur_under_a_caller_mask_matches_jax():
    img = np.random.default_rng(22).integers(0, 256, (20, 24, 4), np.uint8)
    mask = np.zeros((20, 24), np.uint8)
    mask[4:12, 6:18] = 255
    src = "apply_blur(2.5);"
    ref = _run(jengine, src, img, mask)
    out = _run(tengine, src, img, mask)
    np.testing.assert_array_equal(out[0], ref[0])


@pytest.mark.parametrize("src", ["apply_median(2);", "apply_bulge(0.7);"])
def test_spatial_effects_under_a_caller_mask_match_jax(src):
    img = np.random.default_rng(23).integers(0, 256, (20, 24, 4), np.uint8)
    mask = np.zeros((20, 24), np.uint8)
    mask[4:12, 6:18] = 255
    ref = _run(jengine, src, img, mask)
    out = _run(tengine, src, img, mask)
    np.testing.assert_array_equal(out[0], ref[0])


@pytest.mark.parametrize("source", [
    "let x = ;",
    "apply_blur(1.0, 2.0);",
    "apply_median(2.0);",
    "apply_bulge();",
    "apply_oil_painting(2.5);",
    "apply_glow(1.0);",
    'resize_canvas("a", 3);',
    "let a = [1]; a[5];",
    "undefined_fn(3);",
    'throw "boom";',
])
def test_errors_match_jax(source):
    img = np.zeros((4, 4, 4), np.uint8)
    with pytest.raises(jengine.ScriptError) as je:
        _run(jengine, source, img)
    with pytest.raises(tengine.ScriptError) as te:
        _run(tengine, source, img)
    assert (te.value.message, te.value.line, te.value.column) == (
        je.value.message, je.value.line, je.value.column)
    assert te.value.friendly_message() == je.value.friendly_message()


# ops that once raised "not yet ported", and their arguments
_ONCE_UNPORTED = {"apply_twist": "40.0", "apply_glow": "2.0, 1.2",
                  "resize_image": '17, 11, "lanczos3"'}


@pytest.mark.parametrize("name", ["apply_twist", "apply_glow", "resize_image"])
def test_unported_op_is_a_script_error(name):
    """Each op that raised "not yet ported" runs, against the JAX engine:
    twist within 1 of it (its cos/sin come from a host field, ROADMAP C2),
    glow within 1 (its true divide, C9), resize identical."""
    img = np.random.default_rng(24).integers(0, 256, (18, 26, 4), np.uint8)
    src = f"{name}({_ONCE_UNPORTED[name]});"
    ref = _run(jengine, src, img)
    out = _run(tengine, src, img)
    assert out[1:] == ref[1:]
    diff = np.abs(out[0].astype(int) - ref[0].astype(int))
    assert diff.max() <= (0 if name == "resize_image" else 1)
    assert np.mean(diff > 0) < 1e-3


def test_host_functions_are_the_jax_packages():
    """Every host function the JAX build_host_fns registers is registered
    by the port, name for name, and none of them is a stub."""
    from paintfe_tpu.scripting import api as japi
    from paintfe_tpu_torch.scripting import api as tapi

    img = np.zeros((2, 2, 4), np.uint8)
    jnames = set(japi.build_host_fns(japi.ScriptContext(img, 2, 2, None, rng_seed=0), {}))
    tnames = set(tapi.build_host_fns(
        tapi.ScriptContext(img, 2, 2, None, rng_seed=0, device="cpu"), {}))
    assert tnames == jnames
    assert not hasattr(tapi, "NOT_YET_PORTED")


def test_entry_points_default_to_the_card():
    import inspect

    from paintfe_tpu_torch.scripting.api import ScriptContext

    for fn in (tengine.execute_script_sync, ScriptContext):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_asking_for_the_card_without_one_raises():
    import torch

    from paintfe_tpu_torch.scripting.api import ScriptContext

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = np.zeros((4, 4, 4), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.execute_script_sync("apply_median(1);", img, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScriptContext(img, 4, 4, None, device="cuda")
