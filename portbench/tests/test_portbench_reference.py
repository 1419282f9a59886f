"""The frozen references against the port's own plain versions (CPU, small
sizes, tolerance 0), and each kernel's count against a hand count."""

import numpy as np
import pytest
import torch

from portbench.counts import kchain, kcomposite
from portbench.reference import blend, composite, fused_chain, gaussian_blur, strips


def _noise(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape + (4,), generator=g, dtype=torch.uint8)


def _with_clear_alpha(img, seed):
    """Alpha of 0, 255 and values between, so both fast paths run."""
    img = img.clone()
    g = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, 3, img.shape[:-1], generator=g)
    img[..., 3] = torch.where(pick == 0, 0, torch.where(pick == 1, 255, img[..., 3]))
    return img


CHAIN = dict(sigma=2.0, brightness=-17.5, contrast=33.25, black=12.0, white=240.5,
             gamma=0.85, sepia_strength=0.7, blend_opacity=0.45)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0, 3.0])
def test_gaussian_blur_is_the_ports(sigma):
    from paintfe_tpu_torch.ops.kernels import gaussian_blur_plain

    img = _noise(1, 37, 53)
    assert torch.equal(gaussian_blur.apply(img, sigma), gaussian_blur_plain(img, sigma))


@pytest.mark.parametrize("mode", range(25))
@pytest.mark.parametrize("opacity", [0.0, 0.37, 1.0])
def test_blend_is_the_ports(mode, opacity):
    from paintfe_tpu_torch.core.blend import blend_u8

    base = _with_clear_alpha(_noise(2, 19, 23), 3)
    top = _with_clear_alpha(_noise(4, 19, 23), 5)
    assert torch.equal(blend.blend_u8(base, top, mode, opacity), blend_u8(base, top, mode, opacity))


def test_composite_is_the_ports():
    from paintfe_tpu_torch.ops.kernels import composite_stack_plain

    layers = torch.stack([_with_clear_alpha(_noise(10 + k, 21, 17), 40 + k) for k in range(25)])
    modes = list(range(25))
    opacities = np.linspace(0.2, 1.0, 25, dtype=np.float32)
    assert torch.equal(composite.apply(layers, modes, opacities),
                       composite_stack_plain(layers, modes, opacities))


def test_fused_chain_is_the_ports():
    from paintfe_tpu_torch.ops.fused_chain import fused_chain as port_chain

    img, ov = _noise(6, 41, 29), _with_clear_alpha(_noise(7, 41, 29), 8)
    assert torch.equal(fused_chain.apply(img, ov, **CHAIN), port_chain(img, ov, **CHAIN))


def test_levels_table_is_the_ports():
    from paintfe_tpu_torch.parallel.pipeline import levels_lut

    for black, white, gamma in [(0.0, 255.0, 1.0), (12.0, 240.5, 0.85), (29.9, 225.1, 1.249)]:
        assert np.array_equal(fused_chain.levels_lut(black, white, gamma),
                              levels_lut(black, white, gamma))


def test_chain_in_strips_is_the_whole_chain():
    img, ov = _noise(11, 70, 31), _with_clear_alpha(_noise(12, 70, 31), 13)
    whole = fused_chain.apply(img, ov, **CHAIN)
    parts = strips.by_strips(lambda a, b: fused_chain.apply(a, b, **CHAIN), (img, ov), 16,
                             fused_chain.context_rows(CHAIN["sigma"]))
    assert torch.equal(parts, whole)


def test_kchain_count_by_hand():
    # 10 x 8 pixels, 13 taps, 30 pixels of overlay not clear:
    # 2 passes x 13 taps x (multiply + add) x 4 channels = 208 a pixel,
    # 36 a pixel of tail, 55 a covered pixel
    assert kchain.ops(px=80, taps=13, overlay_px=30) == 80 * 208 + 80 * 36 + 30 * 55
    assert kchain.nbytes(px=80, taps=13, overlay_px=30) == 3 * 80 * 4


def test_kcomposite_count_by_hand():
    # NORMAL runs 40 ops, MULTIPLY 43, XOR 29, OVERWRITE 13, SOFT_LIGHT 58
    assert kcomposite.ops(px=100, modes=[0, 1, 13, 14, 16], runs_px=[10, 20, 30, 40, 50]) == \
        10 * 40 + 20 * 43 + 30 * 29 + 40 * 13 + 50 * 58
    assert kcomposite.nbytes(px=100, modes=[0, 1, 13, 14, 16], runs_px=[0] * 5) == 6 * 100 * 4
    assert set(kcomposite.MIXER_OPS) | {13, 14} == set(range(25))


@pytest.mark.cuda
def test_references_on_the_card_are_the_cpus():
    """On the card the references give the CPU's bytes (the comparison
    runs there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img, ov = _noise(18, 70, 65), _with_clear_alpha(_noise(19, 70, 65), 20)
    dev = torch.device("cuda")
    assert torch.equal(fused_chain.apply(img.to(dev), ov.to(dev), **CHAIN).cpu(),
                       fused_chain.apply(img, ov, **CHAIN))
    layers = torch.stack([_with_clear_alpha(_noise(30 + k, 33, 17), 60 + k) for k in range(25)])
    opac = np.linspace(0.2, 1.0, 25, dtype=np.float32)
    assert torch.equal(composite.apply(layers.to(dev), range(25), opac).cpu(),
                       composite.apply(layers, range(25), opac))
