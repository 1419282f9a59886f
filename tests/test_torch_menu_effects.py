"""The port's menu effects against the JAX package's, on the CPU, with and
without a selection mask, at tolerance 0: the gradient tool
(ops/gradient), the bokeh and zoom blurs (ops/filters), dents
(ops/effects/distort), grid, canvas border and drop shadow
(ops/effects/render), pixel drag and RGB displace (ops/effects/glitch),
contours (ops/effects/contours) and the colour filter
(ops/effects/artistic).  All of them are IEEE-basic in the port: the
turbulence fields and row hashes are host numpy (bit-identical to the JAX
package's), the sqrts correctly rounded and the divides true divides."""

import numpy as np
import pytest
import torch

from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.ops import gradient as jgradient
from paintfe_tpu.ops.effects import artistic as jartistic
from paintfe_tpu.ops.effects import contours as jcontours
from paintfe_tpu.ops.effects import distort as jdistort
from paintfe_tpu.ops.effects import glitch as jglitch
from paintfe_tpu.ops.effects import render as jrender
from paintfe_tpu_torch.ops import filters, gradient
from paintfe_tpu_torch.ops.effects import artistic, contours, distort, glitch, render

SHAPES = [(64, 64), (96, 128)]


def _img(seed, h, w):
    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    a[: h // 6, :, 3] = 0
    a[h // 2:, w // 3: w // 2, 3] = 255
    return a


def _mask(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    m = ((xx - w * 0.45) ** 2 / (w * 0.3) ** 2 + (yy - h * 0.5) ** 2 / (h * 0.35) ** 2) <= 1
    return np.where(m, 255, 0).astype(np.uint8)


_MODULES = {"filters": (jfilters, filters), "distort": (jdistort, distort),
            "render": (jrender, render), "glitch": (jglitch, glitch),
            "contours": (jcontours, contours), "artistic": (jartistic, artistic)}

CASES = [
    ("filters", "bokeh_blur", (3.0,)), ("filters", "bokeh_blur", (1.7,)),
    ("filters", "bokeh_blur", (0.4,)), ("filters", "bokeh_blur", (9.5,)),
    ("filters", "zoom_blur", (0.5, 0.5, 0.3, 8)),
    ("filters", "zoom_blur", (0.2, 0.7, 0.6, 5, (1.0, 0.5, 0.2, 1.0), 0.6)),
    ("filters", "zoom_blur", (0.9, 0.1, 1.5, 1)),
    ("distort", "dents", (8.0, 0.5)),
    ("distort", "dents", (5.0, 1.2, 7, 3, 0.6, True, False)),
    ("distort", "dents", (12.0, 2.0, 11, 1, 0.4, True, True)),
    ("distort", "dents", (0.2, 3.0, 3, 9, 0.7, False, True)),
    ("render", "grid", (10, 12, 2, (255, 0, 0, 255))),
    ("render", "grid", (7, 5, 1, (20, 200, 90, 128), 1, 0.45)),
    ("render", "canvas_border", (3, (250, 240, 10, 255))),
    ("render", "canvas_border", (500, (1, 2, 3, 4))),
    ("render", "drop_shadow", (4, 5, 3.0, False, (0, 0, 0, 200), 0.8)),
    ("render", "drop_shadow", (-6, 2, 2.5, True, (30, 10, 90, 255), 0.6)),
    ("render", "drop_shadow", (3, -4, 0.4, True, (255, 255, 255, 128), 1.0)),
    ("glitch", "pixel_drag", (42, 60.0, 10, 0.0)),
    ("glitch", "pixel_drag", (7, 35.0, 25, 135.0)),
    ("glitch", "rgb_displace", ((3, 0), (0, -2), (-4, 5))),
    ("contours", "contours", (12.0, 6.0, 1.5, (0, 0, 0, 255))),
    ("contours", "contours", (5.0, 3.3, 0.4, (200, 40, 40, 180), 9, 3, 0.8)),
    ("artistic", "color_filter", ((255, 128, 0, 255), 0.6, 0)),
    ("artistic", "color_filter", ((40, 90, 200, 255), 0.8, 1)),
    ("artistic", "color_filter", ((200, 60, 120, 255), 0.5, 2)),
    ("artistic", "color_filter", ((90, 200, 30, 255), 0.7, 3)),
    ("artistic", "color_filter", ((0, 255, 200, 255), 1.0, 3)),
]


def _id(case):
    return case[1]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_menu_effect_equals_jax(case, with_mask, shape):
    mod, name, args = case
    jmod, tmod = _MODULES[mod]
    img = _img(len(name) + len(args), *shape)
    mask = _mask(*shape) if with_mask else None
    ref = np.asarray(getattr(jmod, name)(img, *args, mask=mask))
    out = getattr(tmod, name)(img, *args, mask=mask, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_menu_effects_change_the_image():
    """The cases do real work at this size (no case returns its input)."""
    img = _img(3, 64, 64)
    same = [name for mod, name, args in CASES
            if np.array_equal(getattr(_MODULES[mod][1], name)(img, *args, device="cpu")
                              .numpy(), img)]
    assert same == ["bokeh_blur"]  # radius 0.4 is below the bokeh's 0.5


def test_batched_blurs_equal_per_frame():
    frames = np.stack([_img(k, 48, 64) for k in range(3)])
    for fn, args in ((filters.bokeh_blur, (2.5,)), (filters.zoom_blur, (0.3, 0.6, 0.4, 6)),
                     (distort.dents, (6.0, 0.8))):
        out = fn(torch.from_numpy(frames), *args).numpy()
        for k in range(3):
            np.testing.assert_array_equal(out[k], fn(frames[k], *args, device="cpu").numpy())


GRADIENTS = [
    (jgradient.GradientShape.LINEAR, (5.0, 7.0), (50.0, 40.0), False),
    (jgradient.GradientShape.LINEAR, (60.0, 10.0), (20.0, 30.0), True),
    (jgradient.GradientShape.LINEAR_REFLECTED, (10.0, 10.0), (40.0, 50.0), False),
    (jgradient.GradientShape.LINEAR_REFLECTED, (10.0, 10.0), (25.0, 18.0), True),
    (jgradient.GradientShape.RADIAL, (32.5, 30.0), (60.0, 45.0), False),
    (jgradient.GradientShape.RADIAL, (20.0, 20.0), (28.0, 22.0), True),
    (jgradient.GradientShape.DIAMOND, (30.0, 35.0), (50.0, 20.0), False),
    (jgradient.GradientShape.DIAMOND, (30.0, 35.0), (38.0, 31.0), True),
    (jgradient.GradientShape.LINEAR, (9.0, 9.0), (9.0, 9.0), False),
]
GRADIENT_STOPS = [(0.0, (255, 0, 0, 255)), (0.3, (0, 255, 0, 128)),
                  (0.3, (10, 10, 250, 255)), (1.0, (250, 250, 250, 0))]


@pytest.mark.parametrize("eraser", [False, True], ids=["color", "eraser"])
@pytest.mark.parametrize("k", range(len(GRADIENTS)))
def test_render_gradient_equals_jax(k, eraser):
    shape, start, end, repeat = GRADIENTS[k]
    h, w = 60, 70
    base = _img(k, h, w)
    kw = dict(shape=shape, repeat=repeat, eraser=eraser, base=base if eraser else None)
    if k % 2:
        kw["stops"] = GRADIENT_STOPS
    else:
        kw.update(color_a=(10, 200, 30, 255), color_b=(240, 20, 220, 90))
    ref = jgradient.render_gradient(w, h, start, end, **kw)
    out = gradient.render_gradient(w, h, start, end, device="cpu", **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("stops", [[], [(0.5, (1, 2, 3, 4))], GRADIENT_STOPS,
                                   [(0.9, (0, 0, 0, 255)), (0.1, (255, 255, 255, 255))]])
def test_gradient_lut_equals_jax(stops):
    np.testing.assert_array_equal(gradient.gradient_lut(stops), jgradient.gradient_lut(stops))


@pytest.mark.parametrize("entry", ["sepia", "bokeh", "gradient", "warp", "dents", "grid"])
def test_numpy_input_runs_on_the_card_by_default(entry):
    """A numpy image goes to `device`, the card by default: without one
    the call raises, it never runs on the CPU unasked."""
    from paintfe_tpu_torch.ops import adjustments, transform

    img = _img(1, 16, 16)
    call = {"sepia": lambda: adjustments.sepia(img),
            "bokeh": lambda: filters.bokeh_blur(img, 2.0),
            "gradient": lambda: gradient.render_gradient(16, 16, (0, 0), (9, 9),
                                                         (0, 0, 0, 255), (255, 0, 0, 255)),
            "warp": lambda: transform.warp_displacement(img, np.zeros((16, 16, 2), np.float32)),
            "dents": lambda: distort.dents(img, 4.0, 0.5),
            "grid": lambda: render.grid(img, 4, 4, 1, (0, 0, 0, 255))}[entry]
    if torch.cuda.is_available():
        assert call().is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("pair", ["luts", "gradient", "glitch", "contours", "render",
                                  "artistic", "filters", "distort", "transform"])
def test_public_names_of_the_slice_are_ported(pair):
    """Every public name of the slice's JAX modules has its counterpart."""
    from paintfe_tpu.ops import luts as jluts
    from paintfe_tpu.ops import transform as jtransform
    from paintfe_tpu_torch.ops import luts, transform

    names = {"luts": ["identity_lut", "levels_lut", "stretch_lut", "curves_tangents",
                      "curves_lut", "compose_luts", "multi_channel_luts",
                      "levels_multi_channel_luts", "gradient_map_lut"],
             "gradient": ["GradientShape", "gradient_lut", "render_gradient"],
             "glitch": ["pixel_drag", "rgb_displace"], "contours": ["contours"],
             "render": ["GridStyle", "grid", "canvas_border", "drop_shadow"],
             "artistic": ["ColorFilterMode", "color_filter"],
             "filters": ["bokeh_blur", "zoom_blur"], "distort": ["dents"],
             "transform": ["DisplacementField", "catmull_rom_weights", "catmull_rom_surface",
                           "generate_displacement_from_mesh", "warp_mesh_catmull_rom",
                           "uniform_grid"]}[pair]
    jmod, tmod = {"luts": (jluts, luts), "gradient": (jgradient, gradient),
                  "transform": (jtransform, transform)}.get(pair) or _MODULES[pair]
    for name in names:
        assert hasattr(jmod, name) and hasattr(tmod, name), name
    for enum_name in [n for n in names if n[0].isupper() and n != "DisplacementField"]:
        assert ({m.name: m.value for m in getattr(tmod, enum_name)}
                == {m.name: m.value for m in getattr(jmod, enum_name)})
