"""The port's gaussian_blur_pallas (two K-pass launches on the card; on the
CPU, two runs of K-pass's plain version gaussian_blur_pass_plain) against
the JAX package's gaussian_blur_pallas in interpret mode and its
filters.gaussian_blur: the same seeded u8 images, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.ops.pallas_kernels import _conv_pass
from paintfe_tpu.ops.pallas_kernels import gaussian_blur_pallas as jpallas
from paintfe_tpu_torch.ops import kernels
from paintfe_tpu_torch.ops.filters import gaussian_kernel


def _img(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (4,), np.uint8)
    img[: shape[0] // 4, :, 3] = 0
    return img


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0, 5.0])
@pytest.mark.parametrize("shape", [(48, 64), (37, 61)])
def test_blur_matches_the_pallas_kernel_in_interpret_mode(shape, sigma):
    img = _img(shape, int(sigma * 10))
    ref = np.asarray(jpallas(img, sigma, interpret=True))
    out = kernels.gaussian_blur_pallas(torch.from_numpy(img), sigma)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("sigma", [0.3, 2.0, 8.0, 25.0])
@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (40, 52), (19, 130)])
def test_blur_matches_the_xla_gaussian(shape, sigma):
    """Radii above the image edge included: every tap clamps."""
    img = _img(shape, 5)
    ref = np.asarray(jfilters.gaussian_blur(jnp.asarray(img), sigma))
    out = kernels.gaussian_blur_pallas(torch.from_numpy(img), sigma)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("sigma", [1.0, 3.3])
def test_one_pass_matches_the_pallas_pass(sigma):
    """The f32 pass itself, on f32 data that is not u8-valued."""
    rng = np.random.default_rng(7)
    x = (rng.random((3, 10, 45)) * 300).astype(np.float32)
    taps = gaussian_kernel(sigma)
    ref = np.asarray(_conv_pass(jnp.asarray(x), jnp.asarray(taps), len(taps) // 2, 8, True))
    out = kernels.gaussian_blur_pass(torch.from_numpy(x), taps)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_pass_wrapper_takes_the_plain_version_only_on_the_cpu():
    x = torch.rand((2, 4, 9))
    before = kernels.gaussian_blur_pass.launches
    out = kernels.gaussian_blur_pass(x, gaussian_kernel(1.0))
    assert kernels.gaussian_blur_pass.launches == before
    assert torch.equal(out, kernels.gaussian_blur_pass_plain(x, gaussian_kernel(1.0)))
