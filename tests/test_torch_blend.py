"""paintfe_tpu_torch.core.blend against paintfe_tpu.core.blend: the same
seeded u8 inputs through both, tolerance 0 (the blend is IEEE-basic f32
math plus a correctly rounded sqrt)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paintfe_tpu.core import blend as jblend
from paintfe_tpu_torch.core import blend as tblend
from paintfe_tpu_torch.utils import quant as tquant


def _pair(seed, shape=(24, 40)):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, shape + (4,), np.uint8)
    top = rng.integers(0, 256, shape + (4,), np.uint8)
    # alpha edges: clear and opaque rows on both sides, every combination
    base[0, :, 3] = 0
    base[1, :, 3] = 255
    top[2, :, 3] = 0
    top[3, :, 3] = 255
    top[4, ::2, 3] = 0
    base[4, 1::2, 3] = 0
    top[5, :, 3] = 255
    base[5, :, 3] = 0
    return base, top


@pytest.mark.parametrize("opacity", [0.3, 0.6, 1.0])
@pytest.mark.parametrize("mode", list(tblend.BlendMode))
def test_blend_u8_matches_jax(mode, opacity):
    base, top = _pair(int(mode) * 7 + int(opacity * 10))
    ref = np.asarray(jblend.blend_u8(jnp.asarray(base), jnp.asarray(top),
                                     int(mode), opacity))
    out = tblend.blend_u8(torch.from_numpy(base), torch.from_numpy(top),
                          mode, opacity).numpy()
    np.testing.assert_array_equal(out, ref)


def test_blend_mode_ids_match_jax():
    assert [(m.name, int(m)) for m in tblend.BlendMode] == [
        (m.name, int(m)) for m in jblend.BlendMode]
    assert tblend.BlendMode.from_name("soft light") is tblend.BlendMode.SOFT_LIGHT


def test_soft_light_sqrt_is_correctly_rounded():
    # torch's CPU sqrt gives 0x3F3614BF for sqrt(129/255); the correctly
    # rounded value, which numpy and XLA give, is 0x3F3614C0
    b = torch.tensor([129.0], dtype=torch.float32) / torch.tensor(255.0)
    got = tquant.sqrt_f32(b).numpy().view(np.uint32)[0]
    want = np.sqrt(np.float32(129.0) / np.float32(255.0)).view(np.uint32)
    assert got == want == 0x3F3614C0
    # and through the mixer: base 129, top above 0.5 takes the sqrt branch
    t = torch.tensor([200.0], dtype=torch.float32) / torch.tensor(255.0)
    ref = np.asarray(jblend._soft_light(jnp.asarray(b.numpy()), jnp.asarray(t.numpy())))
    np.testing.assert_array_equal(tblend._soft_light(b, t).numpy(), ref)


def test_soft_light_sweeps_every_u8_pair():
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    b, t = np.meshgrid(v, v, indexing="ij")
    ref = np.asarray(jblend._soft_light(jnp.asarray(b), jnp.asarray(t)))
    out = tblend._soft_light(torch.from_numpy(b), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
