"""The port's Content-Aware Fill (paintfe_tpu_torch.ops.inpaint, on
native/inpaint.cpp in the port's one g++ library) on the CPU against the
JAX package's paintfe_tpu.ops.inpaint (its native library) and against the
plain Python oracles `_patchmatch_py` / `_instant_brush_py`, tolerance 0:
PatchMatch at both quality tiers and several patch sizes, holes at the
edges, opaque and transparent; instant-brush dabs of several radii and
hardnesses; the cases of tests/test_inpaint.py; the build, and a failed
build raising."""

import numpy as np
import pytest

from paintfe_tpu.ops import inpaint as jinpaint
from paintfe_tpu_torch import native
from paintfe_tpu_torch.ops import inpaint as tinpaint


def _pattern(transparent=False, size=64):
    """tests/test_inpaint.py's checkerboard with a square hole."""
    img = np.zeros((size, size, 4), np.uint8)
    cx = np.arange(size) // 8
    checker = (cx[None, :] + cx[:, None]) % 2 == 0
    img[checker] = [200, 50, 50, 255]
    img[~checker] = [50, 50, 200, 255]
    mask = np.zeros((size, size), np.uint8)
    mask[24:40, 24:40] = 255
    if transparent:
        img[24:40, 24:40] = 0
    return img, mask


def _noise_hole(seed, h, w, box):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    img[..., :3] //= 3
    img[..., :3] += (np.arange(w, dtype=np.uint8) // 2)[None, :, None]
    mask = np.zeros((h, w), np.uint8)
    y0, y1, x0, x1 = box
    mask[y0:y1, x0:x1] = 255
    return img, mask


def test_the_library_builds_with_the_inpainting_entries():
    lib = native.load()
    assert "inpaint.cpp" in [s.name for s in native.SOURCES]
    assert lib.patchmatch_fill.argtypes and lib.inpaint_instant_brush.argtypes


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", native.SOURCES + (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.load()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tinpaint.fill_region_patchmatch(*_pattern())
    finally:
        native.load.cache_clear()


CASES = {
    "checker": (lambda: _pattern(), ),
    "checker transparent": (lambda: _pattern(True), ),
    "noise centre": (lambda: _noise_hole(1, 40, 48, (10, 22, 15, 30)), ),
    "noise at the edge": (lambda: _noise_hole(2, 33, 45, (0, 9, 38, 45)), ),
    "noise two holes": (lambda: _noise_hole(3, 36, 36, (4, 10, 4, 12)), ),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("quality", ["BALANCED", "HIGH_QUALITY"])
def test_patchmatch_equals_jax(case, quality):
    img, mask = CASES[case][0]()
    if case == "noise two holes":
        mask[20:30, 22:33] = 255
    q = tinpaint.ContentAwareQuality[quality]
    want = jinpaint.fill_region_patchmatch(img, mask, q.patch_size, q.patchmatch_iters)
    got = tinpaint.fill_region_patchmatch(img, mask, q.patch_size, q.patchmatch_iters)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[mask == 0], img[mask == 0])


@pytest.mark.parametrize("patch,iters", [(3, 1), (4, 3), (9, 5), (1, 2)])
def test_patchmatch_oracle_equals_native(patch, iters):
    """The plain Python oracle gives the C++'s bytes at small size."""
    img, mask = _noise_hole(patch, 24, 28, (8, 15, 9, 17))
    got = tinpaint.fill_region_patchmatch(img, mask, patch, iters)
    np.testing.assert_array_equal(got, tinpaint._patchmatch_py(img, mask, patch, iters))
    np.testing.assert_array_equal(got, jinpaint.fill_region_patchmatch(img, mask, patch, iters))


DABS = [(32.0, 32.0, 12.0, 24.0, 0.8), (20.5, 15.2, 9.0, 6.0, 0.6),
        (1.0, 62.5, 20.0, 30.0, 0.0), (40.0, 30.0, 0.5, 3.0, 1.0), (-5.0, 70.0, 8.0, 8.0, 0.5)]


@pytest.mark.parametrize("dab", range(len(DABS)))
@pytest.mark.parametrize("transparent", [False, True])
def test_instant_brush_equals_jax_and_the_oracle(dab, transparent):
    img, mask = _pattern(transparent)
    out0 = np.random.default_rng(dab).integers(0, 256, img.shape, np.uint8)
    want = jinpaint.inpaint_instant_brush(img, mask, out0.copy(), *DABS[dab])
    got = tinpaint.inpaint_instant_brush(img, mask, out0.copy(), *DABS[dab])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tinpaint._instant_brush_py(img, mask, out0.copy(), *DABS[dab]), got)


def test_instant_brush_fills_a_non_contiguous_array_through_a_copy():
    """As in the JAX package: a non-contiguous `out` is filled as a
    contiguous copy, which is returned; outside the brush the source stays."""
    img, mask = _pattern()
    wide = np.zeros((64, 128, 4), np.uint8)
    wide[:, ::2] = img
    got = tinpaint.inpaint_instant_brush(img, mask, wide[:, ::2], 32.0, 32.0, 12.0, 24.0, 0.8)
    want = jinpaint.inpaint_instant_brush(img, mask, wide[:, ::2], 32.0, 32.0, 12.0, 24.0, 0.8)
    assert got.flags["C_CONTIGUOUS"] and not np.shares_memory(got, wide)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], img[0, 0])
    np.testing.assert_array_equal(got[63, 63], img[63, 63])


def test_patchmatch_fills_the_hole_and_keeps_the_rest():
    """tests/test_inpaint.py: the transparent hole comes back opaque, the
    rows above it unchanged."""
    img, mask = _pattern(True)
    got = tinpaint.fill_region_patchmatch(img, mask, 5, 3)
    assert (got[24:40, 24:40, 3] > 128).all()
    np.testing.assert_array_equal(got[:24], img[:24])


def test_quality_tiers_equal_jax():
    for q in jinpaint.ContentAwareQuality:
        t = tinpaint.ContentAwareQuality(q.value)
        assert (t.patch_size, t.patchmatch_iters) == (q.patch_size, q.patchmatch_iters)
    q = tinpaint.ContentAwareQuality
    assert q.INSTANT.patchmatch_iters == 0
    assert q.BALANCED.patchmatch_iters == 3 and q.BALANCED.patch_size == 5
    assert q.HIGH_QUALITY.patchmatch_iters == 6 and q.HIGH_QUALITY.patch_size == 7
