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


@pytest.mark.parametrize("r,th", [(0, 64), (6, 64), (180, 64), (200, 54),
                                  (223, 8), (224, 0), (1000, 0)])
def test_tile_rows_fit_shared_memory(r, th):
    def smem(rows):  # csrc/blur_tile.cuh tile_smem_bytes
        return (rows + 2 * r) * tkernels.TILE_W * 16

    assert tkernels.tile_rows(r) == th
    if th:
        assert smem(th) <= tkernels.MAX_SMEM
        assert 2 * r + 1 <= 512  # the kernels' constant tap table
    else:
        assert smem(tkernels.MIN_TILE_H) > tkernels.MAX_SMEM
