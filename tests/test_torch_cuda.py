"""The port's CUDA kernels on the card: each against its plain version on
the same device, tolerance 0.  Marked `cuda`; every test skips when no
CUDA device is present (the CPU test run), and runs on the card with

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from paintfe_tpu_torch.core.blend import BlendMode, blend_u8
from paintfe_tpu_torch.ops import kernels
from paintfe_tpu_torch.ops.fused_chain import fused_chain, fused_chain_kernel
from paintfe_tpu_torch.parallel import pipeline
from paintfe_tpu_torch.utils.quant import ieee_div

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _img(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, tuple(shape) + (4,), np.uint8)).to(dev)


@pytest.mark.parametrize("sigma", [0.5, 2.0, 8.0, 25.0, 80.0])
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (4, 70, 45)])
def test_blur_kernel_equals_plain(dev, shape, sigma):
    img = _img(shape, 1, dev)
    before = kernels.gaussian_blur_fused.launches
    out = kernels.gaussian_blur_fused(img, sigma)
    assert kernels.gaussian_blur_fused.launches == before + 1
    assert torch.equal(out, kernels.gaussian_blur_plain(img, sigma))


@pytest.mark.parametrize("sigma", [1.0, 2.0, 60.0, 80.0])
def test_chain_kernel_equals_plain(dev, sigma):
    img, ov = _img((65, 97), 2, dev), _img((65, 97), 3, dev)
    ov[:7, :, 3] = 0
    img[30:33, :, 3] = 0
    before = fused_chain_kernel.launches
    out = fused_chain_kernel(img, ov, sigma=sigma)
    assert fused_chain_kernel.launches == before + 1
    assert torch.equal(out, fused_chain(img, ov, sigma=sigma))


def test_kernels_refuse_bad_tensors(dev):
    img = _img((16, 20), 4, dev)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gaussian_blur_fused(img.transpose(0, 1), 2.0)
    with pytest.raises(TypeError, match="uint8"):
        kernels.gaussian_blur_fused(img.float(), 2.0)
    with pytest.raises(ValueError, match="overlay"):
        fused_chain_kernel(img, _img((16, 21), 5, dev))


def test_ieee_div_is_a_true_divide_on_the_card(dev):
    x = torch.arange(256, dtype=torch.float32, device=dev)
    want = (np.arange(256, dtype=np.float32) / np.float32(255.0))
    assert np.array_equal(ieee_div(x, 255.0).cpu().numpy(), want)


@pytest.mark.parametrize("mode", list(BlendMode))
def test_blend_on_the_card_equals_the_cpu(dev, mode):
    base, top = _img((33, 41), 6, dev), _img((33, 41), 7, dev)
    top[:3, :, 3] = 0
    got = blend_u8(base, top, mode, 0.6).cpu()
    assert torch.equal(got, blend_u8(base.cpu(), top.cpu(), mode, 0.6))


def test_run_batch_on_the_card_equals_the_cpu(dev):
    ops = pipeline.trace_script(
        "apply_blur(2.0); apply_brightness_contrast(10.0, 20.0); "
        "apply_levels(10.0, 245.0, 1.1); apply_sepia(0.5); flip_vertical();")
    images = _img((3, 40, 56), 8, "cpu").numpy()
    assert np.array_equal(pipeline.run_batch(images, ops, dev),
                          pipeline.run_batch(images, ops, "cpu"))
