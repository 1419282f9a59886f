"""The port's bilinear gather (ops/warp_kernel.py), bulge
(ops/effects/distort.py) and displacement warp (ops/transform.py) against
the JAX package, tolerance 0: the plain gather in both modes against the
Pallas gather_bilinear_u8 run in interpret mode and against its XLA
oracles, bulge against distort.bulge, warp_displacement against
transform.warp_displacement."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paintfe_tpu.ops import transform as jtfm
from paintfe_tpu.ops import warp_kernel as jwarp
from paintfe_tpu.ops.effects import distort as jdistort
from paintfe_tpu.utils.quant import round_u8 as jround_u8
from paintfe_tpu_torch.ops import transform as ttfm
from paintfe_tpu_torch.ops import warp_kernel as twarp
from paintfe_tpu_torch.ops.effects import distort as tdistort

H, W = 64, 280  # the JAX package's warp-kernel test size

# the fields of tests/test_warp_kernel.py
FIELDS = {
    "identity": lambda xx, yy: (xx, yy),
    "const_shift": lambda xx, yy: (xx - 7.25, yy + 3.5),
    "swirl": lambda xx, yy: (xx - 4 * np.sin(yy / 13.0),
                             yy - 4 * np.cos(xx / 17.0)),
    "deep_oob": lambda xx, yy: (xx - 60.0, yy - 60.0),
    "half_px": lambda xx, yy: (xx - 0.5, yy - 0.5),
}


def _src(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (4,), np.uint8)


def _field(name, h=H, w=W):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return tuple(v.astype(np.float32) for v in FIELDS[name](xx, yy))


def _plain(src, sx, sy, mode):
    return twarp.gather_bilinear_plain(torch.from_numpy(src), torch.from_numpy(sx),
                                       torch.from_numpy(sy), mode).numpy()


def _oracle(src, sx, sy, mode):
    """The XLA formulations the Pallas kernel's two modes follow."""
    hs, ws = src.shape[:2]
    if mode == "zero":
        out, _ = jax.jit(lambda s, a, b: jtfm._bilinear_gather_zero(
            s, a, b, hs, ws))(src, jnp.asarray(sx), jnp.asarray(sy))
    else:
        out = jax.jit(lambda s, a, b: jround_u8(jdistort.sample_bilinear(s, a, b)))(
            src, jnp.asarray(sx), jnp.asarray(sy))
    return np.asarray(out)


@pytest.mark.parametrize("mode", ["zero", "clamp"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_gather_matches_pallas_interpret(name, mode):
    src = _src((H, W), 1)
    sx, sy = _field(name)
    # the planned entry plans once per key and never builds the checked
    # program, so each mode compiles one interpret program
    ref = jwarp.gather_bilinear_u8_planned(src, sx, sy, ("torch-port", name),
                                           mode=mode, interpret=True)
    assert ref is not None
    np.testing.assert_array_equal(_plain(src, sx, sy, mode), np.asarray(ref))


@pytest.mark.parametrize("mode", ["zero", "clamp"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_gather_matches_oracle_on_random_fields(mode, seed):
    """Random fields reaching well outside the source (and a source of
    another size than the field)."""
    rng = np.random.default_rng(seed)
    src = _src((23, 41), 30 + seed)
    sx = rng.uniform(-12.0, 53.0, (17, 29)).astype(np.float32)
    sy = rng.uniform(-12.0, 35.0, (17, 29)).astype(np.float32)
    sx[0, :5] = [-1.0, -0.5, -2.0, 40.0, 41.0]  # edges of the oob rule
    np.testing.assert_array_equal(_plain(src, sx, sy, mode), _oracle(src, sx, sy, mode))


@pytest.mark.parametrize("mode", ["zero", "clamp"])
def test_batched_gather_equals_each_image(mode):
    batch = np.stack([_src((20, 30), s) for s in range(3)])
    sx, sy = (v[:20, :30] - 2.25 for v in _field("swirl"))
    sx, sy = np.ascontiguousarray(sx), np.ascontiguousarray(sy)
    out = twarp.gather_bilinear_u8(torch.from_numpy(batch), torch.from_numpy(sx),
                                   torch.from_numpy(sy), mode).numpy()
    for k in range(3):
        np.testing.assert_array_equal(out[k], _oracle(batch[k], sx, sy, mode))


def test_gather_refuses_unknown_mode():
    src = torch.zeros((4, 4, 4), dtype=torch.uint8)
    f = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="mode"):
        twarp.gather_bilinear_u8(src, f, f, "wrap")


@pytest.mark.parametrize("shape", [(37, 53), (64, 280)])
@pytest.mark.parametrize("amount", [-1.0, -0.3, 0.5, 1.0])
def test_bulge_matches_jax(amount, shape):
    img = _src(shape, 7)
    ref = np.asarray(jdistort.bulge(img, amount, (0.5, 0.5)))
    out = tdistort.bulge(torch.from_numpy(img), amount, (0.5, 0.5))
    assert out.dtype == torch.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("amount,origin", [(0.0, (0.5, 0.5)), (0.8, (0.0, 1.0)),
                                           (-0.6, (0.3, 0.8)), (2.5, (1.4, -0.2))])
def test_bulge_other_origins_and_a_mask_match_jax(amount, origin):
    img = _src((31, 47), 8)
    mask = np.zeros((31, 47), np.uint8)
    mask[5:20, 10:40] = 1
    ref = np.asarray(jdistort.bulge(img, amount, origin, mask))
    out = tdistort.bulge(torch.from_numpy(img), amount, origin, mask)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_bulge_field_matches_jax_coords():
    """The f32 field itself (sqrt taken correctly rounded, the divide a true
    IEEE divide) equals the JAX package's bit for bit."""
    h, w = 45, 77
    sx, sy, norm = jdistort._bulge_field(0.5, 0.5, 0.5, h, w)
    tx, ty, tn = tdistort.bulge_field(0.5, (0.5, 0.5), h, w, device="cpu")
    for a, b in ((sx, tx), (sy, ty), (norm, tn)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_batched_bulge_equals_each_image():
    batch = np.stack([_src((26, 33), s) for s in range(3)])
    out = tdistort.bulge(torch.from_numpy(batch), 0.5).numpy()
    for k in range(3):
        np.testing.assert_array_equal(out[k], np.asarray(jdistort.bulge(batch[k], 0.5)))


@pytest.mark.parametrize("src_shape", [(40, 52), (31, 70)])
def test_warp_displacement_matches_jax(src_shape):
    rng = np.random.default_rng(9)
    src = _src(src_shape, 9)
    field = (rng.standard_normal((40, 52, 2)) * 6.0).astype(np.float32)
    field[:4, :, 0] = 70.0  # rows sampled from outside the source
    ref = np.asarray(jtfm.warp_displacement(src, field))
    out = ttfm.warp_displacement(torch.from_numpy(src), torch.from_numpy(field))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ttfm.warp_displacement(src, field, device="cpu").numpy(),
                                  ref)


@pytest.mark.parametrize("w,offset,want", [
    (3840, 0, ("vector", 960, 0)),   # 4K, every address aligned
    (512, 0, ("vector", 128, 0)),
    (511, 0, ("scalar", 127, 3)),    # a tail group of 3 pixels a row
    (3838, 0, ("scalar", 959, 2)),
    (3841, 0, ("scalar", 960, 1)),
    (3840, 4, ("scalar", 960, 0)),   # a field 4 bytes off a 16-byte boundary
    (3840, 8, ("scalar", 960, 0)),
    (4, 0, ("vector", 1, 0)),
    (3, 0, ("scalar", 0, 3)),        # one tail group only
    (1, 12, ("scalar", 0, 1)),
])
def test_warp_split_picks_vector_scalar_and_tail(w, offset, want):
    """K-warp's paths (csrc/warp_bilinear.cu, decided by the wrapper): the
    16-byte path only where the row width is a multiple of WARP_PX and both
    fields and the output are 16-byte aligned; otherwise 4-byte accesses,
    with a tail group of w % WARP_PX pixels.  An offset moves one field."""
    assert twarp.WARP_PX == 4
    base = 0x7F0000001000
    assert twarp.warp_split(w, base + offset, base + 0x100000, base + 0x200000) == want
    assert twarp.warp_split(w, base, base + 0x100000 + offset, base + 0x200000) == want
    path, groups, tail = want
    assert groups * twarp.WARP_PX + tail == w


def test_fraction_from_the_floor_equals_the_converted_integers():
    """csrc/warp_bilinear.cu takes fx = x - clip(floor(x), -2^31, 2^31)
    where the first design converted floor(x) to int32 and back (cvt.rzi
    saturates; a NaN converts to 0): the same fraction for every f32
    coordinate, in range, past +-2^31, infinite or NaN."""
    rng = np.random.default_rng(4)
    x = np.concatenate([
        (rng.random(20000) * 1e4 - 5e3), rng.standard_normal(2000) * 3e9,
        np.arange(-70, 70) / 8, [2.0 ** 31, -2.0 ** 31, 2.0 ** 31 - 128, 3e38, -3e38,
                                 np.inf, -np.inf, np.nan, 0.0, -0.0]]).astype(np.float32)
    fl = np.floor(x)
    converted = np.where(np.isnan(fl), 0, np.clip(fl, -2.0 ** 31, 2.0 ** 31 - 1)).astype(
        np.float64)
    old = (x.astype(np.float64) - converted.astype(np.float32).astype(np.float64)).astype(
        np.float32)
    new = x - np.fmin(np.fmax(fl, np.float32(-2.0 ** 31)), np.float32(2.0 ** 31))
    np.testing.assert_array_equal(np.isnan(new), np.isnan(old))
    np.testing.assert_array_equal(new[~np.isnan(new)], old[~np.isnan(old)])
