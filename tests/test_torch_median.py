"""The port's median (ops/filters.median, ops/kernels.median_plain, the
K-median wrapper) against the JAX package's filters.median and its Pallas
median_pallas run in interpret mode, tolerance 0, on seeded inputs."""

import numpy as np
import pytest
import torch

from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.ops.pallas_kernels import median_pallas
from paintfe_tpu_torch.ops import filters as tfilters
from paintfe_tpu_torch.ops import kernels

# 37x53 and 45x131: neither a multiple of 8 rows nor of 128 columns
SHAPES = [(37, 53), (45, 131)]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (4,), np.uint8)


def _mask(shape):
    m = np.zeros(shape, np.uint8)
    m[3:shape[0] - 5, 7:shape[1] // 2] = 255
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r", [1, 2, 3])
def test_median_matches_jax(r, shape, masked):
    img = _img(shape, 10 + r)
    mask = _mask(shape) if masked else None
    ref = np.asarray(jfilters.median(img, r, mask))
    out = tfilters.median(torch.from_numpy(img), r, mask)
    assert out.dtype == torch.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r", [1, 2, 3])
def test_median_plain_matches_median_pallas(r, shape):
    img = _img(shape, 20 + r)
    ref = np.asarray(median_pallas(img, r, interpret=True))
    np.testing.assert_array_equal(kernels.median_plain(torch.from_numpy(img), r).numpy(), ref)


@pytest.mark.parametrize("radius", [0, -3])
def test_radius_below_one_is_one(radius):
    img = _img((12, 17), 3)
    np.testing.assert_array_equal(
        tfilters.median(torch.from_numpy(img), radius).numpy(),
        np.asarray(jfilters.median(img, radius)))


def test_batch_equals_each_image():
    batch = np.stack([_img((21, 34), s) for s in range(3)])
    out = tfilters.median(torch.from_numpy(batch), 2).numpy()
    for k in range(3):
        np.testing.assert_array_equal(out[k], np.asarray(jfilters.median(batch[k], 2)))


@pytest.mark.parametrize("k2", [9, 25, 49, 81, 121])
def test_layered_network_selects_the_median(k2):
    """The pruned Batcher network, run one layer of disjoint comparators at
    a time, leaves the exact median at k2 // 2."""
    rng = np.random.default_rng(k2)
    vals = rng.integers(0, 256, (k2, 500)).astype(np.int32)
    work = vals.copy()
    for lo, hi in kernels._median_layers(k2):
        assert not set(lo) & set(hi) and len(set(lo + hi)) == 2 * len(lo)
        a, b = work[lo], work[hi]
        work[lo], work[hi] = np.minimum(a, b), np.maximum(a, b)
    np.testing.assert_array_equal(work[k2 // 2], np.sort(vals, axis=0)[k2 // 2])


def test_tiny_and_single_pixel_images():
    for shape in [(1, 1), (1, 9), (7, 1), (2, 3)]:
        img = _img(shape, 4)
        np.testing.assert_array_equal(
            tfilters.median(torch.from_numpy(img), 2).numpy(),
            np.asarray(jfilters.median(img, 2)))


def test_route_switches_to_global_past_the_shared_memory():
    # (32 + 2r)^2 u32 of tile and halo against the 232448 bytes of a block
    assert kernels.median_route(1) == "staged"
    assert kernels.median_route(104) == "staged"
    assert kernels.median_route(105) == "global"


def test_kernel_wrapper_refuses_bad_radius_and_counts_no_cpu_launch():
    img = torch.from_numpy(_img((8, 8), 5))
    with pytest.raises(ValueError, match="radius"):
        kernels.median_kernel(img, 0)
    before = kernels.median_kernel.launches
    kernels.median_kernel(img, 1)
    assert kernels.median_kernel.launches == before
