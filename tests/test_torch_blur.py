"""The port's Gaussian blur (ops/filters.py, ops/kernels.py) against the
JAX package, tolerance 0: the same seeded u8 images through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.ops.pallas_kernels import gaussian_blur_fused as j_blur_fused
from paintfe_tpu_torch.ops import filters as tfilters
from paintfe_tpu_torch.ops import kernels as tkernels


def _img(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, tuple(shape) + (4,), np.uint8)


@pytest.mark.parametrize("sigma", [0.1, 0.3, 0.5, 1.0, 1.1, 2.0, 3.3, 5.0,
                                   8.0, 12.5, 25.0, 33.3, 50.0])
def test_gaussian_kernel_bytes_match_jax(sigma):
    a = tfilters.gaussian_kernel(sigma)
    b = jfilters.gaussian_kernel(sigma)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


# the shapes and sigmas of tests/test_pallas.py's fused-blur test, plus a
# large radius
@pytest.mark.parametrize("shape,sigma", [
    ((100, 173), 2.0), ((64, 64), 5.0), ((257, 511), 3.3), ((33, 40), 1.1),
    ((64, 96), 25.0),
])
def test_plain_blur_matches_jax(shape, sigma):
    img = _img(shape)
    ref = np.asarray(jax.jit(lambda x: jfilters.gaussian_blur(x, sigma))(img))
    out = tkernels.gaussian_blur_plain(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape,sigma", [((33, 40), 1.1), ((100, 173), 2.0)])
def test_wrapper_matches_jax_pallas_kernel_in_interpret_mode(shape, sigma):
    img = _img(shape, seed=2)
    ref = np.asarray(j_blur_fused(img, sigma, interpret=True))
    out = tkernels.gaussian_blur_fused(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_array_equal(out, ref)


def test_batched_blur_equals_per_image():
    batch = np.stack([_img((31, 45), seed=s) for s in range(3)])
    out = tkernels.gaussian_blur_fused(torch.from_numpy(batch), 2.0).numpy()
    for k in range(3):
        ref = np.asarray(jfilters.gaussian_blur(batch[k], 2.0))
        np.testing.assert_array_equal(out[k], ref)


def test_planar_entry_matches_jax():
    img = _img((29, 37), seed=3)
    planar = np.ascontiguousarray(np.transpose(img, (2, 0, 1)))
    from paintfe_tpu.ops.pallas_kernels import gaussian_blur_fused_planar

    ref = np.asarray(gaussian_blur_fused_planar(planar, 29, 37, 2.0, interpret=True))
    out = tkernels.gaussian_blur_fused_planar(torch.from_numpy(planar), 29, 37, 2.0)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("mask_kind", ["rect", "empty", "none"])
def test_blur_with_selection_matches_jax(mask_kind):
    img = _img((48, 64), seed=4)
    mask = np.zeros((48, 64), np.uint8)
    if mask_kind == "rect":
        mask[10:30, 20:41] = 255
        mask[40, 5] = 1
    elif mask_kind == "none":
        mask = None
    ref = np.asarray(jfilters.gaussian_blur_with_selection(img, 2.0, mask))
    out = tfilters.gaussian_blur_with_selection(torch.from_numpy(img), 2.0, mask)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_masked_blur_matches_jax():
    img = _img((40, 52), seed=5)
    mask = (np.random.default_rng(6).random((40, 52)) > 0.5).astype(np.uint8)
    ref = np.asarray(jfilters.gaussian_blur(jnp.asarray(img), 1.5, mask))
    out = tfilters.gaussian_blur(torch.from_numpy(img), 1.5, mask)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cpu_tensor_takes_plain_path_without_counting():
    img = torch.from_numpy(_img((20, 30), seed=7))
    before = tkernels.gaussian_blur_fused.launches
    out = tkernels.gaussian_blur_fused(img, 2.0)
    assert tkernels.gaussian_blur_fused.launches == before
    np.testing.assert_array_equal(
        out.numpy(), tkernels.gaussian_blur_plain(img, 2.0).numpy())


def test_wrapper_refuses_non_cpu_non_cuda_and_bad_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.check_rgba_u8(torch.zeros((4, 4, 4), dtype=torch.uint8), "x")
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.gaussian_blur_fused(
            torch.zeros((4, 4, 4), dtype=torch.uint8, device="meta"), 2.0)


def _chain_limit():
    return next(r for r in range(1000) if tkernels.chain_tile_rows(r) == 0) - 1


@pytest.mark.parametrize("radius", ["0", "4", "5", "6", "limit", "limit+1", "180", "200",
                                    "223", "224", "1000"])
def test_chain_tile_and_tables_fit_shared_memory(radius):
    """K-chain's staged tile: K-blur's tile geometry with the chain's
    tables (three of 256 f32, and the taps padded to four f32) in the same
    block's shared memory.  Up to the limit the tile
    runs, with K-blur's rows and sums a thread and at least BLUR_MIN_CHUNK
    staged rows; past it K-blur runs and then the tail alone."""
    limit = _chain_limit()
    assert 75 <= limit < _split_limit()  # the tables cost K-chain at most a few radii
    r = limit + 1 if radius == "limit+1" else limit if radius == "limit" else int(radius)
    tables = tkernels.chain_tables_bytes(r)
    assert tables == 3 * 256 * 4 + 4 * (-(-(2 * r + 1) // 4) * 4)
    assert tables % 16 == 0  # the float4 sums after the tables stay aligned
    th = tkernels.chain_tile_rows(r)
    if r > limit:
        assert th == 0
        assert (r <= tkernels.BLUR_SHORT_MAX_R
                or tkernels.blur_chunk_rows(tkernels.BLUR_TILE_H, r, tables)
                < tkernels.BLUR_MIN_CHUNK)
        return
    assert th == tkernels.blur_tile_rows(r)
    assert th % tkernels.blur_sums(r) == 0
    chunk = tkernels.blur_chunk_rows(th, r, tables)
    assert tkernels.BLUR_MIN_CHUNK <= chunk <= th + 2 * r
    nbytes = tkernels.blur_tile_bytes(th, r, tables)
    sums = (th + 2 * r) * tkernels.TILE_W * 16
    assert nbytes == tables + sums + chunk * tkernels.blur_src_pitch(r) * 4
    assert nbytes <= tkernels.MAX_SMEM == 232448
    # one row more in a chunk would not fit, unless every row is staged at once
    assert (chunk == th + 2 * r
            or nbytes + tkernels.blur_src_pitch(r) * 4 * -(-(th + 2 * r) // chunk)
            > tkernels.MAX_SMEM)
    if r <= tkernels.BLUR_SHORT_MAX_R:  # four blocks an SM, as K-blur's short tile
        assert 4 * (nbytes + 1024) <= 233472
    assert tkernels.blur_tile_bytes(th, r) == nbytes - tables + (
        tkernels.blur_chunk_rows(th, r) - chunk) * tkernels.blur_src_pitch(r) * 4


def _split_limit():
    return next(r for r in range(1000) if tkernels.blur_tile_rows(r) == 0) - 1


@pytest.mark.parametrize("radii", ["0-24", "25-75", "76-limit", "limit+1", "223",
                                   "224", "1000"])
def test_tile_rows_fit_shared_memory(radii):
    """K-blur's staged tile: every radius up to the split limit gets a tile
    of BLUR_SHORT_TILE_H rows up to BLUR_SHORT_MAX_R, of BLUR_TILE_H above
    (whole strips of the sums a thread computes), whose H sums and at least
    BLUR_MIN_CHUNK staged source rows fit a block's 232448 bytes (a quarter
    of the SM's for the short tile, which runs four blocks an SM); every
    radius past it takes the split route."""
    limit = _split_limit()
    lo, _, hi = radii.partition("-")
    lo = limit + 1 if lo == "limit+1" else int(lo)
    hi = limit if hi == "limit" else int(hi or lo)
    for r in range(lo, hi + 1):
        th = tkernels.blur_tile_rows(r)
        if r > limit:
            assert th == 0, r
            continue
        chunk = tkernels.blur_chunk_rows(th, r)
        short = r <= tkernels.BLUR_SHORT_MAX_R
        assert th == (tkernels.BLUR_SHORT_TILE_H if short else tkernels.BLUR_TILE_H), r
        assert tkernels.blur_sums(r) == (tkernels.BLUR_SHORT_Q if short else tkernels.BLUR_Q)
        assert th % tkernels.blur_sums(r) == 0, r
        if short:
            assert 4 * (tkernels.blur_tile_bytes(th, r) + 1024) <= 233472, r
        assert tkernels.BLUR_MIN_CHUNK <= chunk <= th + 2 * r, r
        assert tkernels.blur_tile_bytes(th, r) <= tkernels.MAX_SMEM == 232448, r
        assert 2 * r + 1 <= 512  # the kernels' constant tap table
    assert 75 <= limit < 223


def _conv_run(values, taps, q):
    """blur_tile.cuh conv_run on the CPU, in f32: q sums from windows cur|nxt
    of q loaded values each, taps in blocks of q (loads past the end clamp
    to the last value, which no sum uses)."""
    nt = len(taps)
    acc = [np.float32(0)] * q

    def load(j):
        return values[min(j, len(values) - 1)]

    def taps_block(cur, nxt, kb):
        for kk in range(q):
            if kb + kk < nt:
                for i in range(q):
                    v = cur[i + kk] if i + kk < q else nxt[i + kk - q]
                    acc[i] = np.float32(acc[i] + np.float32(v * taps[kb + kk]))

    a = [load(j) for j in range(q)]
    for kb in range(0, nt, 2 * q):
        b = [load(kb + q + j) for j in range(q)]
        taps_block(a, b, kb)
        if kb + q >= nt:
            break
        a = [load(kb + 2 * q + j) for j in range(q)]
        taps_block(b, a, kb + q)
    return acc


@pytest.mark.parametrize("q", [4, 8])
@pytest.mark.parametrize("sigma", [0.1, 0.5, 1.0, 2.0, 2.5, 5.0, 8.0, 25.0])
def test_register_blocked_sums_keep_the_tap_order(sigma, q):
    """Each of the q sums of a thread (BLUR_SHORT_Q or BLUR_Q) takes its
    taps in order from 0, so it equals the plain ordered sum bit for bit."""
    assert {tkernels.BLUR_SHORT_Q, tkernels.BLUR_Q} == {4, 8}
    taps = tfilters.gaussian_kernel(sigma)
    values = np.random.default_rng(8).integers(0, 256, q + len(taps) - 1).astype(np.float32)
    want = []
    for i in range(q):
        s = np.float32(0)
        for k, t in enumerate(taps):
            s = np.float32(s + np.float32(values[i + k] * t))
        want.append(s)
    got = _conv_run(values, taps, q)
    assert np.array(got, np.float32).tobytes() == np.array(want, np.float32).tobytes()


def test_u8_to_f32_by_exponent_bits_is_exact():
    """u8_pixel.cuh u8x4_to_f32: the bits 0x4B0000bb are 2^23 + bb as an
    f32, and subtracting 2^23 leaves bb exactly."""
    b = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | b).view(np.float32) - np.float32(8388608.0)
    np.testing.assert_array_equal(f, b.astype(np.float32))


# numpy mirrors of csrc/u8_pixel.cuh and csrc/unpremultiply.cuh, which
# K-blur, K-chain, K-warp and K-composite share


def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s): byte i of the result is byte s's
    nibble i (0-7) of the eight bytes y:x."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    both = (y << np.uint64(32)) | x
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        sel = np.uint64((s >> (4 * i)) & 7)
        out |= ((both >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _add_directed(v, mode):
    """f32 v + 2^23 rounded down ("rd", __fadd_rd) or toward zero ("rz",
    __fadd_rz), as f32 bits: the exact sum in f64, then the nearest f32
    stepped one ulp toward the direction where it overshoots."""
    exact = v.astype(np.float64) + 2.0 ** 23
    near = exact.astype(np.float32)
    over = near.astype(np.float64) > exact if mode == "rd" else (
        np.abs(near.astype(np.float64)) > np.abs(exact))
    near = np.where(over, np.nextafter(near, np.float32(0) if mode == "rz" else -np.inf,
                                       dtype=np.float32), near)
    return near.view(np.uint32)


def _u8x4_to_f32(p):
    return np.stack([_byte_perm(p, 0x4B000000, sel).view(np.float32) - np.float32(2.0 ** 23)
                     for sel in (0x7540, 0x7541, 0x7542, 0x7543)], -1)


def _round_byte(x):
    f32 = np.float32
    return _add_directed(np.fmin(np.fmax(x + f32(0.5), f32(0)), f32(255)), "rd")


def _pack_low(r, g, b, a):
    return _byte_perm(_byte_perm(r, g, 0x0040), _byte_perm(b, a, 0x0040), 0x5410)


@pytest.mark.parametrize("position", range(4))
def test_u8x4_to_f32_mirror_takes_each_byte_of_every_value(position):
    """u8x4_to_f32 (__byte_perm with 2^23, then a subtraction): every one of
    the 256 byte values at each position of a word, beside random bytes in
    the others, comes back as its exact f32."""
    rng = np.random.default_rng(position)
    b = np.arange(256, dtype=np.uint32)
    words = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    words = (words & ~np.uint32(0xFF << (8 * position))) | (b << np.uint32(8 * position))
    got = _u8x4_to_f32(words)
    want = np.stack([(words >> np.uint32(8 * c)) & np.uint32(0xFF) for c in range(4)], -1)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert got.dtype == np.float32


def test_round_byte_mirror_is_floor_half_up_clipped():
    """round_byte on every f32 in [-1, 257] on a 1/64 grid, and on NaN and
    the infinities: the word is 2^23 + floor(v + 0.5) clipped to [0, 255]
    (0 for NaN), so its low byte is the rounded byte and its f32 value less
    2^23 is that byte exactly."""
    v = (np.arange(-64, 257 * 64 + 1) / 64).astype(np.float32)
    v = np.concatenate([v, np.float32([np.nan, np.inf, -np.inf])])
    want = np.clip(np.floor(v.astype(np.float64) + 0.5), 0, 255)
    want = np.where(np.isnan(v), 0, want).astype(np.uint32)
    bits = _round_byte(v)
    np.testing.assert_array_equal(bits, np.uint32(0x4B000000) + want)
    np.testing.assert_array_equal(bits.view(np.float32) - np.float32(2.0 ** 23),
                                  want.astype(np.float32))
    # round_pack: the four low bytes in RGBA order
    rng = np.random.default_rng(3)
    ch = [rng.choice(v, 4096) for _ in range(4)]
    packed = _pack_low(*[_round_byte(c) for c in ch])
    want4 = [np.where(np.isnan(c), 0, np.clip(np.floor(c.astype(np.float64) + 0.5), 0, 255))
             for c in ch]
    np.testing.assert_array_equal(
        packed, sum(w.astype(np.uint32) << np.uint32(8 * i) for i, w in enumerate(want4)))


def test_truncating_cast_mirror_is_floor():
    """unpremultiply.cuh trunc_bits (an add of 2^23 rounded toward zero) on
    every f32 in [0, 256) on a 1/64 grid and the values just below each
    integer: the low byte is floor(v), and the same word comes from the
    f32 value of the byte (the chain's round trip through byte_value)."""
    v = (np.arange(0, 256 * 64) / 64).astype(np.float32)
    below = np.nextafter(np.arange(1, 256, dtype=np.float32), np.float32(0))
    v = np.concatenate([v, below])
    bits = _add_directed(v, "rz")
    floor = np.floor(v.astype(np.float64)).astype(np.uint32)
    np.testing.assert_array_equal(bits, np.uint32(0x4B000000) + floor)
    np.testing.assert_array_equal(bits.view(np.float32) - np.float32(2.0 ** 23),
                                  floor.astype(np.float32))
