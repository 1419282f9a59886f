"""The port's Liquify and mesh warp (ops/transform: DisplacementField and
its four brushes, warp_displacement of a field, the Catmull-Rom weights,
surface, mesh displacement, mesh warp and uniform grid) against the JAX
package's, on the CPU, at tolerance 0: the fields bit for bit, the warped
images byte for byte."""

import numpy as np
import pytest
import torch

from paintfe_tpu.ops import transform as jtfm
from paintfe_tpu_torch.ops import transform as tfm

f32 = np.float32


def _img(seed, h=72, w=96):
    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    a[: h // 8, :, 3] = 0
    return a


# (brush, args after the centre): push (dx, dy, radius, strength), expand
# and contract (radius, strength), twirl (radius, strength, clockwise)
STROKES = [
    ("apply_push", (30.0, 25.0), (6.0, -4.0, 14.0, 0.8)),
    ("apply_push", (-3.0, 10.0), (2.0, 2.0, 9.0, 1.0)),
    ("apply_expand", (60.0, 40.0), (18.0, 0.7)),
    ("apply_expand", (50.5, 20.25), (0.5, 0.3)),
    ("apply_contract", (20.0, 50.0), (12.0, 0.9)),
    ("apply_twirl", (70.0, 30.0), (16.0, 1.2, True)),
    ("apply_twirl", (45.0, 45.0), (10.0, 0.6, False)),
    ("apply_push", (500.0, -40.0), (6.0, 6.0, 10.0, 1.0)),  # off the canvas
]


def _fields(strokes, h=72, w=96):
    t, j = tfm.DisplacementField(w, h), jtfm.DisplacementField(w, h)
    for brush, centre, args in strokes:
        assert getattr(t, brush)(*centre, *args) == getattr(j, brush)(*centre, *args)
    return t, j


@pytest.mark.parametrize("k", range(len(STROKES)))
def test_brush_equals_jax(k):
    t, j = _fields(STROKES[k:k + 1])
    assert t.data.dtype == np.float32
    np.testing.assert_array_equal(t.data.view(np.uint32), j.data.view(np.uint32))


def test_strokes_accumulate_like_jax():
    t, j = _fields(STROKES)
    np.testing.assert_array_equal(t.data.view(np.uint32), j.data.view(np.uint32))
    assert np.abs(t.data).max() > 1.0


@pytest.mark.parametrize("as_object", [True, False], ids=["field", "array"])
def test_field_warp_equals_jax(as_object):
    t, j = _fields(STROKES)
    img = _img(1)
    ref = np.asarray(jtfm.warp_displacement(img, j if as_object else j.data))
    out = tfm.warp_displacement(torch.from_numpy(img), t if as_object else t.data)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_catmull_rom_weights_equal_jax():
    t = np.random.default_rng(2).random(4096).astype(f32)
    t[:4] = (0.0, 1.0, 0.5, 0.9999)
    ref = jtfm.catmull_rom_weights(t)
    out = tfm.catmull_rom_weights(torch.from_numpy(t))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))


def _deformed(cols, rows, w, h, seed):
    grid = tfm.uniform_grid(cols, rows, w, h)
    jitter = np.random.default_rng(seed).uniform(-0.12, 0.12, grid.shape).astype(f32)
    return grid, (grid + jitter * f32(max(w, h) / max(cols, rows))).astype(f32)


@pytest.mark.parametrize("cols,rows", [(4, 3), (1, 1), (6, 5), (2, 7)])
def test_uniform_grid_and_surface_equal_jax(cols, rows):
    w, h = 96, 72
    grid, deformed = _deformed(cols, rows, w, h, cols * 10 + rows)
    np.testing.assert_array_equal(grid, jtfm.uniform_grid(cols, rows, w, h))
    uv = np.random.default_rng(cols).uniform(-0.5, max(cols, rows) + 0.5,
                                             (2, 40, 50)).astype(f32)
    ref = jtfm.catmull_rom_surface(deformed, cols, rows, uv[0], uv[1])
    out = tfm.catmull_rom_surface(deformed, cols, rows, torch.from_numpy(uv[0]),
                                  torch.from_numpy(uv[1]))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("fast", [False, True], ids=["surface", "fast"])
@pytest.mark.parametrize("cols,rows,out_w,out_h", [(4, 3, 96, 72), (3, 2, 77, 51),
                                                   (5, 4, 128, 96)])
def test_mesh_displacement_equals_jax(cols, rows, out_w, out_h, fast):
    orig, deformed = _deformed(cols, rows, out_w, out_h, out_w)
    ref = jtfm.generate_displacement_from_mesh(orig, deformed, cols, rows, out_w, out_h,
                                               fast=fast)
    out = tfm.generate_displacement_from_mesh(orig, deformed, cols, rows, out_w, out_h,
                                              fast=fast, device="cpu")
    assert out.shape == (out_h, out_w, 2) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("cols,rows,size", [(4, 3, None), (3, 2, (80, 60)), (2, 2, None)])
def test_mesh_warp_equals_jax(cols, rows, size):
    img = _img(cols + rows)
    h, w = img.shape[:2]
    orig, deformed = _deformed(cols, rows, w, h, 7 * cols)
    out_w, out_h = size if size else (None, None)
    ref = np.asarray(jtfm.warp_mesh_catmull_rom(img, orig, deformed, cols, rows,
                                                out_w, out_h))
    out = tfm.warp_mesh_catmull_rom(img, orig, deformed, cols, rows, out_w, out_h,
                                    device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not np.array_equal(out.numpy()[: min(h, ref.shape[0]), : min(w, ref.shape[1])],
                              img[: ref.shape[0], : ref.shape[1]])
