"""The port's traced batch pipeline (parallel/pipeline.py) against the
JAX package's, tolerance 0.  The JAX side runs on the test suite's
8-device CPU mesh."""

import numpy as np
import pytest

from paintfe_tpu.parallel import pipeline as jpipe
from paintfe_tpu_torch.parallel import pipeline as tpipe

HEADLINE = ("apply_blur(2.0); apply_brightness_contrast(10.0, 20.0); "
            "apply_levels(10.0, 245.0, 1.1); apply_sepia(0.5);")

SCRIPTS = [
    HEADLINE,
    "apply_invert(); flip_horizontal(); apply_sepia();",
    "rotate_180(); apply_blur(1); flip_vertical(); apply_levels(0, 200, 2.0);",
    "let s = 1.5; for i in 0..2 { apply_blur(s); } apply_brightness_contrast(-20, 35);",
    "apply_median(2); apply_bulge(0.5);",
    "apply_blur(2.0); apply_median(1); apply_bulge(-0.3); apply_levels(10.0, 245.0, 1.1);",
]


@pytest.mark.parametrize("script", SCRIPTS)
def test_trace_gives_the_jax_ops(script):
    jops = jpipe.trace_script(script)
    tops = tpipe.trace_script(script)
    assert tpipe.from_jax_ops(jops) == tops
    assert [(o.name, o.params) for o in tops] == [(o.name, o.params) for o in jops]


@pytest.mark.parametrize("script", SCRIPTS)
def test_run_batch_matches_jax(script):
    images = np.random.default_rng(11).integers(0, 256, (3, 48, 64, 4), np.uint8)
    images[1, :8, :, 3] = 0
    ops = tpipe.trace_script(script)
    ref = jpipe.run_batch(images, jpipe.trace_script(script))
    out = tpipe.run_batch(images, ops, "cpu")
    assert out.dtype == np.uint8 and out.shape == images.shape
    np.testing.assert_array_equal(out, ref)


def test_dimension_queries_bail_without_dims_and_trace_with_them():
    script = "apply_blur(width() / 32.0);"
    with pytest.raises(tpipe.NotVectorizable, match="width"):
        tpipe.trace_script(script)
    assert tpipe.trace_script(script, dims=(64, 48)) == tpipe.from_jax_ops(
        jpipe.trace_script(script, dims=(64, 48)))


@pytest.mark.parametrize("script,bail", [
    ("apply_twist(2.0);", "apply_twist"),
    ("apply_blur(2.0); apply_glow(3.0, 0.5);", "apply_glow"),
    ("let p = get_pixel(0, 0);", "get_pixel"),
    ("resize_image(10, 10);", "resize_image"),
])
def test_unported_and_pixel_ops_bail(script, bail):
    with pytest.raises(tpipe.NotVectorizable, match=bail):
        tpipe.trace_script(script)


def test_from_jax_ops_refuses_unported_op():
    with pytest.raises(tpipe.NotVectorizable, match="apply_twist"):
        tpipe.from_jax_ops([jpipe.PipelineOp("apply_twist", (2.0,))])


def test_argument_validation_matches_per_image_api():
    from paintfe_tpu_torch.scripting.interp import RhaiRuntimeError

    with pytest.raises(RhaiRuntimeError, match="function not found"):
        tpipe.trace_script("apply_levels(1.0, 2.0);")
    with pytest.raises(RhaiRuntimeError, match="number"):
        tpipe.trace_script('apply_blur("x");')
    with pytest.raises(RhaiRuntimeError, match="integer"):
        tpipe.trace_script("apply_median(2.0);")
    with pytest.raises(RhaiRuntimeError, match="function not found"):
        tpipe.trace_script("apply_bulge();")


def test_median_radius_is_at_least_one_like_jax():
    script = "apply_median(0); apply_median(-4);"
    ops = tpipe.trace_script(script)
    assert ops == tpipe.from_jax_ops(jpipe.trace_script(script))
    assert [o.params for o in ops] == [(1,), (1,)]
