"""The port's headline chain (ops/fused_chain.py) and its device ops
against the JAX package, tolerance 0: the same seeded u8 inputs through
both.  The JAX kernel runs in Pallas interpret mode, as the JAX package's
own tests run it."""

import jax
import numpy as np
import pytest
import torch

from paintfe_tpu.ops import fused_chain as jchain
from paintfe_tpu.parallel import pipeline as jpipe
from paintfe_tpu_torch.ops import fused_chain as tchain
from paintfe_tpu_torch.parallel import pipeline as tpipe


def _pair(seed, shape=(130, 201)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (4,), np.uint8)
    ov = rng.integers(0, 256, shape + (4,), np.uint8)
    ov[:10, :, 3] = 0  # clear-alpha rows pass the base through
    img[20:24, :, 3] = 0  # and a clear base under an opaque overlay
    ov[20:22, :, 3] = 255
    return img, ov


def test_plain_chain_matches_jax_fused_chain():
    img, ov = _pair(3)
    ref = np.asarray(jax.jit(lambda a, b: jchain.fused_chain(a, b))(img, ov))
    out = tchain.fused_chain(torch.from_numpy(img), torch.from_numpy(ov)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_kernel_wrapper_matches_jax_kernel_interpret():
    img, ov = _pair(4)
    ref = np.asarray(jchain.fused_chain_kernel(img, ov, interpret=True))
    before = tchain.fused_chain_kernel.launches
    out = tchain.fused_chain_kernel(torch.from_numpy(img), torch.from_numpy(ov))
    assert tchain.fused_chain_kernel.launches == before  # CPU: plain path
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("params", [
    dict(sigma=0.7, brightness=-30.0, contrast=-40.0, black=0.0, white=255.0,
         gamma=0.45, sepia_strength=1.0, blend_opacity=1.0),
    dict(sigma=3.5, brightness=25.0, contrast=60.0, black=40.0, white=200.0,
         gamma=2.2, sepia_strength=0.0, blend_opacity=0.25),
])
def test_chain_parameters_match_jax(params):
    img, ov = _pair(5, (40, 57))
    ref = np.asarray(jchain.fused_chain_kernel(img, ov, interpret=True, **params))
    out = tchain.fused_chain(torch.from_numpy(img), torch.from_numpy(ov), **params)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_tail_params_match_jax_kernel_scalars():
    p = tchain._tail_params(10.0, 20.0, 0.5, 0.6)
    f32 = np.float32
    assert p.dtype == np.float32
    assert p[1] == (f32(259.0) * (f32(20.0) + f32(255.0))) / (
        f32(255.0) * (f32(259.0) - f32(20.0)))
    assert p[2] == f32(0.5) and p[3] == f32(0.5) and p[4] == f32(0.6)


_LEVELS_PAIRS = [(10.0, 245.0), (0.0, 255.0), (60.0, 180.0), (0.0, 200.0)]


@pytest.mark.parametrize("black,white", _LEVELS_PAIRS)
def test_levels_device_matches_jax_power_for_every_gamma(black, white):
    # every u8 input, 40 gammas: the u8 table equals jnp.power's result
    v = np.arange(256, dtype=np.uint8)
    img = np.stack([v, v[::-1], v, np.full(256, 200, np.uint8)], -1)[None]
    for gamma in [*np.linspace(0.1, 4.0, 40), 0.5, 1.0, 2.0]:
        ref = np.asarray(jpipe._levels_device(img, black, white, float(gamma)))
        out = tpipe._levels_device(torch.from_numpy(img), black, white, float(gamma))
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"gamma={gamma}")


@pytest.mark.parametrize("brightness,contrast", [(10.0, 20.0), (-50.0, -80.0),
                                                 (100.0, 250.0), (0.0, 0.0)])
def test_bc_device_matches_jax(brightness, contrast):
    img = np.random.default_rng(7).integers(0, 256, (3, 17, 19, 4), np.uint8)
    ref = np.asarray(jax.vmap(lambda x: jpipe._bc_device(x, brightness, contrast))(img))
    out = tpipe._bc_device(torch.from_numpy(img), brightness, contrast)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("strength", [None, 0.0, 0.5, 0.73, 1.0, 1.5])
def test_sepia_device_matches_jax(strength):
    img = np.random.default_rng(8).integers(0, 256, (2, 21, 23, 4), np.uint8)
    args = () if strength is None else (strength,)
    ref = np.asarray(jax.jit(lambda x: jpipe._sepia_device(x, *args))(img))
    out = tpipe._sepia_device(torch.from_numpy(img), *args)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kernel_wrapper_validates_cuda_inputs():
    img = torch.zeros((8, 8, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tchain.fused_chain_kernel(img, img)


def test_levels_table_is_the_correctly_rounded_power():
    # black 0, white 200, gamma 2: input 72 normalizes to 0.36, and
    # 0.36 ** 0.5 correctly rounded is 0.6 (x255 = 153.0).  jnp.power and
    # libm give that; numpy's f32 array power on AVX-512 hosts gives 1 ulp
    # less (x255 = 152.99998, truncated to 152).  The port's table follows
    # the correctly rounded power, as the JAX package's batch path does.
    lut = tpipe.levels_lut(0.0, 200.0, 2.0)
    assert lut[72] == 153
    v = np.arange(256, dtype=np.uint8)
    img = np.stack([v, v, v, v], -1)[None]
    ref = np.asarray(jpipe._levels_device(img, 0.0, 200.0, 2.0))[0, :, 0]
    np.testing.assert_array_equal(lut, ref)
