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
    "apply_desaturate(); apply_exposure(0.7); apply_box_blur(2); apply_motion_blur(30.0, 3.0);",
    "apply_sharpen(1.2); apply_glow(2.0, 0.6); apply_vignette(0.5, 0.9); apply_pixelate(3);",
    "apply_crystallize(5); apply_noise(15.0, false); apply_oil_painting(2); apply_ink(40.0, 20.0);",
    "apply_halftone(5.0); apply_exposure(-1.3); apply_box_blur(0);",
]

# the ops whose batched result may differ by 1 from the JAX package's under
# the transcendental rule (ROADMAP C2): twist's cos/sin, reduce-noise's
# exp, monochrome Gaussian noise's log/cos; at most this share of bytes
C2_SCRIPTS = [
    "apply_twist(45.0); apply_reduce_noise(25.0); apply_noise(30.0, true);",
    "apply_blur(1.0); apply_twist(-200.0); apply_sharpen(0.5);",
]
C2_MAX_SHARE = 1e-3


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


@pytest.mark.parametrize("script", C2_SCRIPTS)
def test_c2_ops_trace_and_run_batch_within_one_of_jax(script):
    images = np.random.default_rng(12).integers(0, 256, (2, 48, 64, 4), np.uint8)
    jops = jpipe.trace_script(script)
    ops = tpipe.trace_script(script)
    assert tpipe.from_jax_ops(jops) == ops
    ref = jpipe.run_batch(images, jops)
    diff = np.abs(tpipe.run_batch(images, ops, "cpu").astype(int) - ref.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) < C2_MAX_SHARE


def test_op_table_and_arg_specs_equal_jax():
    """The coverage guard of tests/test_pipeline_equivalence.py, across the
    packages: the port's batched ops and argument specs are the JAX
    package's, name for name, and every op is exercised above."""
    assert set(tpipe._OP_TABLE) == set(jpipe._OP_TABLE)
    assert set(tpipe._build_arg_specs()) == set(jpipe._build_arg_specs())
    called = {op.name for script in SCRIPTS + C2_SCRIPTS
              for op in tpipe.trace_script(script)}
    assert called == set(tpipe._OP_TABLE)


def test_dimension_queries_bail_without_dims_and_trace_with_them():
    script = "apply_blur(width() / 32.0);"
    with pytest.raises(tpipe.NotVectorizable, match="width"):
        tpipe.trace_script(script)
    assert tpipe.trace_script(script, dims=(64, 48)) == tpipe.from_jax_ops(
        jpipe.trace_script(script, dims=(64, 48)))


@pytest.mark.parametrize("script,bail", [
    ("apply_twist(2.0);", None),
    ("apply_blur(2.0); apply_glow(3.0, 0.5);", None),
    ("let p = get_pixel(0, 0);", "get_pixel"),
    ("resize_image(10, 10);", "resize_image"),
])
def test_unported_and_pixel_ops_bail(script, bail):
    """Pixel reads and canvas resizes bail to the per-image path, as in the
    JAX package; twist and glow, once absent, now trace to its ops."""
    if bail is None:
        assert tpipe.trace_script(script) == tpipe.from_jax_ops(jpipe.trace_script(script))
        return
    with pytest.raises(tpipe.NotVectorizable, match=bail):
        tpipe.trace_script(script)
    with pytest.raises(jpipe.NotVectorizable, match=bail):
        jpipe.trace_script(script)


def test_from_jax_ops_refuses_unported_op():
    """from_jax_ops takes every op of the JAX table and refuses a name
    outside it."""
    ops = [jpipe.PipelineOp(name, ()) for name in jpipe._OP_TABLE]
    assert [op.name for op in tpipe.from_jax_ops(ops)] == list(jpipe._OP_TABLE)
    with pytest.raises(tpipe.NotVectorizable, match="apply_unknown"):
        tpipe.from_jax_ops([jpipe.PipelineOp("apply_unknown", (2.0,))])


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
