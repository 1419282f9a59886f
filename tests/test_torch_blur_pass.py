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


def _blocked_pass(x, taps, seg):
    """csrc/blur_pass.cu's staged route in numpy, index for index: a block
    a segment of a row, the segment and its halo staged with clamped
    indices (what is not staged is NaN, so a read past it shows), four
    outputs a thread from an eight-value register window, the taps four at
    a time with the last one to three guarded, full groups stored at once
    and a partial group value by value."""
    taps = np.asarray(taps, np.float32)
    nt = len(taps)
    r = nt // 2
    rows, w = x.shape
    nt4 = -(-nt // 4) * 4
    span = seg + nt4 + 4
    assert kernels.pass_smem_bytes(seg, r) == (span + nt4) * 4
    tp = np.full(nt4, np.nan, np.float32)
    tp[:nt] = taps
    out = np.full_like(x, np.nan)
    threads = -(-(seg // 4) // 32) * 32
    for row in range(rows):
        for seg0 in range(0, w, seg):
            length = min(seg, w - seg0)
            staged = -(-length // 4) * 4 + 2 * r
            assert staged <= span
            s = np.full(span, np.nan, np.float32)
            i = np.arange(staged)
            s[i] = x[row, np.clip(seg0 - r + i, 0, w - 1)]
            for t in range(threads):
                if 4 * t >= length:
                    continue
                acc = np.zeros(4, np.float32)
                a = s[4 * t:4 * t + 4]
                k = 0
                while k < nt:
                    b = s[4 * t + k + 4:4 * t + k + 8]
                    v = np.concatenate([a, b[:3]])
                    for c in range(min(4, nt - k)):
                        acc = acc + v[c:c + 4] * tp[k + c]  # one f32 product, one f32 sum
                    a = b
                    k += 4
                n = min(4, length - 4 * t)
                out[row, seg0 + 4 * t:seg0 + 4 * t + n] = acc[:n]
    return out


# widths 1 and 3 (below one group), 53 and 511 (a scalar tail), 64 (whole
# groups only), 2 and 5 at sigma 2 and 8 (W <= r: every tap clamps)
@pytest.mark.parametrize("w,sigma,seg", [
    (1, 0.5, None), (1, 2.0, None), (3, 0.5, None), (3, 2.0, None), (2, 2.0, None),
    (5, 8.0, None), (53, 0.5, None), (53, 2.0, None), (53, 8.0, None), (53, 25.0, None),
    (64, 2.0, None), (511, 2.0, None), (511, 2.0, 128), (511, 8.0, 64), (53, 2.0, 4),
    (53, 8.0, 16), (64, 1.0, 32)])
def test_blocked_sum_mirror_equals_the_plain_pass(w, sigma, seg):
    rng = np.random.default_rng(w * 7 + int(sigma * 10))
    x = (rng.random((3, w)) * 300 - 20).astype(np.float32)
    taps = gaussian_kernel(sigma)
    seg = kernels.pass_segment(w) if seg is None else seg
    want = kernels.gaussian_blur_pass_plain(torch.from_numpy(x), taps).numpy()
    np.testing.assert_array_equal(_blocked_pass(x, taps, seg), want)


@pytest.mark.parametrize("w", [1, 3, 4, 5, 37, 53, 257, 511, 1024, 1025, 2160, 3840, 7680])
def test_pass_segment_splits_a_row_evenly(w):
    seg = kernels.pass_segment(w)
    assert seg % kernels.PASS_Q == 0 and 0 < seg <= kernels.PASS_MAX_SEG
    nseg = -(-w // seg)
    assert nseg == -(-w // kernels.PASS_MAX_SEG)  # no more blocks than the cap needs
    assert (nseg - 1) * seg < w <= nseg * seg  # every block has work
    assert seg - -(-w // nseg) < kernels.PASS_Q  # and the split is even


@pytest.mark.parametrize("w", [1, 53, 2160, 3840])
def test_pass_route_keeps_the_staged_span_in_shared_memory(w):
    seg = kernels.pass_segment(w)
    staged = [r for r in range(0, 40000, 37) if kernels.pass_route(w, r) == "staged"]
    assert staged and all(kernels.pass_smem_bytes(seg, r) <= kernels.MAX_SMEM for r in staged)
    last = max(r for r in range(40000) if kernels.pass_route(w, r) == "staged")
    assert kernels.pass_route(w, last + 1) == "global"
    assert kernels.pass_smem_bytes(seg, last + 1) > kernels.MAX_SMEM
    # every sigma the scripts use stays on the staged route
    assert last > 3 * 1000
