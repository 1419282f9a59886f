"""The port's affine transforms and canvas transforms
(paintfe_tpu_torch.ops.{transform,canvas_transform}) against the JAX
package's: apply_affine / rotate_arbitrary at 0, 17.5, 45, 90 and -30
degrees in both interpolations, with a scale, an offset, perspective, a
canvas size other than the source's, the degenerate-w and nearest-tie
branches, and a batch; the selected-region and whole-canvas flips and
rotations; rotate_canvas_arbitrary of layers and masks; resize_image,
resize_canvas and crop_to_selection (with a deep payload);
composite_viewport and composite_lod.  The same seeded inputs, device
"cpu" (K-warp's plain version), tolerance 0."""

import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu.ops import canvas_transform as jct
from paintfe_tpu.ops import transform as jtfm
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.core.selection import ellipse_mask, rect_mask
from paintfe_tpu_torch.io.pfe import load_pfe, save_pfe
from paintfe_tpu_torch.ops import canvas_transform as tct
from paintfe_tpu_torch.ops import transform as ttfm

H, W = 96, 128

AFFINE_CASES = [
    dict(rotation_z=0.0), dict(rotation_z=17.5), dict(rotation_z=45.0),
    dict(rotation_z=90.0), dict(rotation_z=-30.0), dict(rotation_z=180.0),
    dict(rotation_z=10.0, scale=1.7, offset=(3.5, -2.0)),
    dict(rotation_z=-12.0, scale=0.45),
    dict(rotation_z=5.0, canvas_size=(150, 70)),
    dict(rotation_z=33.0, canvas_size=(64, 120), offset=(-10.0, 4.25)),
    dict(rotation_x=35.0, rotation_y=-20.0, rotation_z=8.0),
    dict(rotation_x=80.0, rotation_y=30.0),
    # nearest ties: half-integer source coordinates, negative ones included
    dict(scale=2.0), dict(scale=2.0, offset=(100.0, -31.0)),
    # |wq| < 1e-8 on one row (128 pixels) and on one pixel
    dict(rotation_x=-75.0, offset=(0.0, 3.4462432861328125)),
    dict(rotation_x=-75.0, rotation_y=20.0, offset=(0.0, 0.343658447265625)),
]


def _img(seed, shape=(H, W)):
    img = np.random.default_rng(seed).integers(0, 256, tuple(shape) + (4,), np.uint8)
    img[:5, :, 3] = 0
    return img


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
@pytest.mark.parametrize("case", AFFINE_CASES, ids=str)
def test_apply_affine_equals_jax(case, interpolation):
    img = _img(1)
    want = np.asarray(jtfm.apply_affine(img, interpolation=interpolation, **case))
    got = ttfm.apply_affine(img, interpolation=interpolation, device="cpu", **case)
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)


def _map(case):
    cw, ch = case.get("canvas_size", (W, H))
    params = ttfm._affine_params(case.get("rotation_z", 0.0), case.get("rotation_x", 0.0),
                                 case.get("rotation_y", 0.0), case.get("scale", 1.0),
                                 *case.get("offset", (0.0, 0.0)), cw, ch)
    return ttfm._affine_map(params, cw, ch, "cpu")


def test_the_cases_reach_the_degenerate_and_tie_branches():
    assert int(_map(AFFINE_CASES[-2])[2].sum()) == W
    assert int(_map(AFFINE_CASES[-1])[2].sum()) == 1
    for case in AFFINE_CASES[-4:-2]:
        sx, sy, _ = _map(case)
        assert (torch.abs(sx) % 1 == 0.5).any() and (torch.abs(sy) % 1 == 0.5).any()
    sx, _, _ = _map(AFFINE_CASES[-3])
    assert ((sx < 0) & (torch.abs(sx) % 1 == 0.5)).any()


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_apply_affine_batch_equals_each_image(interpolation):
    batch = np.stack([_img(s) for s in range(3)])
    got = ttfm.apply_affine(batch, rotation_z=21.0, scale=1.1, interpolation=interpolation,
                            device="cpu")
    for k in range(3):
        want = np.asarray(jtfm.apply_affine(batch[k], rotation_z=21.0, scale=1.1,
                                            interpolation=interpolation))
        assert np.array_equal(got[k].numpy(), want)


@pytest.mark.parametrize("degrees", [0.0, 0.0009, 17.5, -30.0, 90.0])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_rotate_arbitrary_equals_jax(degrees, interpolation):
    img = _img(2)
    got = ttfm.rotate_arbitrary(img, degrees, interpolation, device="cpu")
    want = jtfm.rotate_arbitrary(img, degrees, interpolation)
    if abs(degrees) < 0.001:
        assert got is img and want is img
    else:
        assert np.array_equal(got.numpy(), np.asarray(want))


def _pair(seed=1, n_layers=4, h=H, w=W):
    doc = chip_smoke.editing_document(np.random.default_rng(seed), h, w, n_layers)
    with tempfile.TemporaryDirectory() as d:
        save_pfe(doc, f"{d}/doc.pfe")
        return load_pfe(f"{d}/doc.pfe"), jpfe.load_pfe(f"{d}/doc.pfe")


def _same(t, j):
    return chip_smoke.document_differences(t, canvas_from_document(j)) == []


def _with_masks(docs, seed):
    """A conceal mask on layers 1 and 2, and a preview the transforms clear."""
    rng = np.random.default_rng(seed)
    masks = [rng.integers(0, 256, (docs[0].height, docs[0].width), np.uint8) for _ in range(2)]
    for doc in docs:
        doc.layers[1].mask, doc.layers[2].mask = masks[0].copy(), masks[1].copy()
        doc.preview = np.zeros((doc.height, doc.width, 4), np.uint8)
    return docs


TRANSFORMS = ["flip_canvas_horizontal", "flip_canvas_vertical", "rotate_canvas_90cw",
              "rotate_canvas_90ccw", "rotate_canvas_180"]
SELECTIONS = {
    "none": lambda: None,
    "all": lambda: np.full((H, W), 255, np.uint8),
    "rect": lambda: rect_mask(W, H, 10, 20, 70, 50),
    "ellipse": lambda: ellipse_mask(W, H, 100.0, 80.0, 40.0, 30.0),
    "empty": lambda: np.zeros((H, W), np.uint8),
}


@pytest.mark.parametrize("selection", list(SELECTIONS))
@pytest.mark.parametrize("name", TRANSFORMS)
def test_canvas_transforms_equal_jax(name, selection):
    t, j = _with_masks(_pair(3), 4)
    for doc in (t, j):
        doc.selection = SELECTIONS[selection]()
    before = [l.pixels for l in t.layers]
    getattr(tct, name)(t)
    getattr(jct, name)(j)
    assert _same(t, j) and t.preview is None
    assert all(l.pixels is not b for l, b in zip(t.layers, before) if l.content == "raster")


@pytest.mark.parametrize("degrees,interpolation", [(17.5, "bilinear"), (-30.0, "nearest"),
                                                   (90.0, "bilinear"), (0.0005, "bilinear"),
                                                   (45.0, "bicubic")])
def test_rotate_canvas_arbitrary_equals_jax(degrees, interpolation):
    t, j = _with_masks(_pair(5), 6)
    tct.rotate_canvas_arbitrary(t, degrees, interpolation, device="cpu")
    jct.rotate_canvas_arbitrary(j, degrees, interpolation)
    assert _same(t, j)


def test_rotate_canvas_arbitrary_after_a_90_rotation_equals_jax():
    """A non-square canvas rotated by 90 degrees pads/crops its masks to the
    new dims; the arbitrary rotation then takes layers and masks of one
    shape in one batch."""
    t, j = _with_masks(_pair(7), 8)
    tct.rotate_canvas_90cw(t)
    jct.rotate_canvas_90cw(j)
    assert _same(t, j) and t.layers[1].mask.shape == (W, H)
    tct.rotate_canvas_arbitrary(t, 17.5, device="cpu")
    jct.rotate_canvas_arbitrary(j, 17.5)
    assert _same(t, j)


@pytest.mark.parametrize("size,interpolation", [((64, 48), "bilinear"), ((150, 100), "nearest"),
                                                ((97, 31), "lanczos3")])
def test_resize_image_equals_jax(size, interpolation):
    t, j = _with_masks(_pair(9), 10)
    for doc in (t, j):
        doc.selection = rect_mask(W, H, 1, 1, 5, 5)
    tct.resize_image(t, *size, interpolation)
    jct.resize_image(j, *size, interpolation)
    assert _same(t, j)


@pytest.mark.parametrize("size,anchor", [((150, 100), (1, 1)), ((60, 40), (2, 0)),
                                         ((128, 50), (0, 2))])
def test_resize_canvas_equals_jax(size, anchor):
    t, j = _with_masks(_pair(11), 12)
    tct.resize_canvas(t, *size, anchor, (1, 2, 3, 4))
    jct.resize_canvas(j, *size, anchor, (1, 2, 3, 4))
    assert _same(t, j)


@pytest.mark.parametrize("selection", ["none", "empty", "rect", "ellipse"])
def test_crop_to_selection_equals_jax(selection):
    from paintfe_tpu.core.deep import DeepRgbaBuffer as JDeep
    from paintfe_tpu.core.deep import PixelFormat as JFormat
    from paintfe_tpu_torch.core.deep import DeepRgbaBuffer, PixelFormat

    t, j = _with_masks(_pair(13), 14)
    deep = np.arange(H * W * 4, dtype=np.uint16) * 7
    t.layers[0].deep_pixels = DeepRgbaBuffer(PixelFormat.RGBA_U16, deep.copy())
    j.layers[0].deep_pixels = JDeep(JFormat.RGBA_U16, deep.copy())
    for doc in (t, j):
        doc.selection = SELECTIONS[selection]()
    tct.crop_to_selection(t)
    jct.crop_to_selection(j)
    assert _same(t, j)
    assert np.array_equal(t.layers[0].deep_pixels.data, j.layers[0].deep_pixels.data)


@pytest.mark.parametrize("rect", [None, (10, 5, 60, 40), (-5, -5, 300, 300), (90, 80, 100, 95)])
def test_composite_viewport_equals_jax(rect):
    t, j = _with_masks(_pair(15, 6), 16)
    for doc in (t, j):
        doc.preview = None
    got = tct.composite_viewport(t, rect, device="cpu")
    assert np.array_equal(got, np.asarray(jct.composite_viewport(j, rect)))


@pytest.mark.parametrize("h,w", [(H, W), (40, 1100), (1030, 20)])
def test_composite_lod_equals_jax(h, w):
    t, j = _pair(17, 4, h, w)
    got = tct.composite_lod(t, device="cpu")
    want = np.asarray(jct.composite_lod(j))
    assert got.shape == want.shape and np.array_equal(got, want)
    assert max(got.shape[:2]) <= tct.LOD_MAX_EDGE


def _document_calls():
    from paintfe_tpu_torch.core.project import Project
    from paintfe_tpu_torch.ops import canvas_ops, fill

    img = _img(3)
    return {
        "apply_affine": lambda t: ttfm.apply_affine(img, rotation_z=3.0),
        "rotate_arbitrary": lambda t: ttfm.rotate_arbitrary(img, 3.0),
        "rotate_canvas_arbitrary": lambda t: tct.rotate_canvas_arbitrary(t, 3.0),
        "composite_viewport": lambda t: tct.composite_viewport(t, (0, 0, 5, 5)),
        "composite_lod": lambda t: tct.composite_lod(t),
        "merge_down": lambda t: canvas_ops.merge_down(t, 2),
        "flatten": lambda t: canvas_ops.flatten(t),
        "magic_wand_mask": lambda t: fill.magic_wand_mask(img, 9, 9, 10.0),
        "bucket_fill": lambda t: fill.bucket_fill(img, 9, 9, (1, 2, 3, 4)),
        "Project.new_untitled": lambda t: Project.new_untitled(1, 8, 8),
    }


@pytest.mark.parametrize("name", list(_document_calls()))
def test_device_work_defaults_to_the_card(name, monkeypatch):
    """Without device=, each entry of the slice that does device work asks
    for the card, and raises when there is none (never a silent CPU run)."""
    t, _ = _pair(19)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _document_calls()[name](t)
