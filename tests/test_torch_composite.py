"""The port's compositor (paintfe_tpu_torch.core.composite, K-composite's
plain version composite_stack_plain) against the JAX package's
composite_stack_static, composite_stack (traced modes, visibility) and the
Pallas composite_stack_pallas in interpret mode: the same seeded u8 layers,
every blend mode, tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paintfe_tpu.core import composite as jcomp
from paintfe_tpu.ops.pallas_kernels import composite_stack_pallas as jpallas
from paintfe_tpu_torch.core import composite as tcomp
from paintfe_tpu_torch.ops import kernels

OPACITIES = (0.0, 0.37, 1.0, 1.5)


def _stack(seed, n, h=23, w=37):
    rng = np.random.default_rng(seed)
    layers = rng.integers(0, 256, (n, h, w, 4), np.uint8)
    # alpha edges in every layer: clear, opaque and mixed rows
    layers[:, 0, :, 3] = 0
    layers[:, 1, :, 3] = 255
    layers[:, 2, ::2, 3] = 0
    conceal = rng.integers(0, 256, (n, h, w), np.uint8)
    conceal[:, 3] = 0
    conceal[:, 4] = 255
    init = rng.integers(0, 256, (h, w, 4), np.uint8)
    init[5:7, :, 3] = 0
    return layers, conceal, init


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("use_init", [False, True])
@pytest.mark.parametrize("use_conceal", [False, True])
@pytest.mark.parametrize("opacity", OPACITIES)
@pytest.mark.parametrize("mode", range(25))
def test_static_matches_jax_every_mode(mode, opacity, use_conceal, use_init):
    # three layers: the mode under test between a NORMAL base and a SCREEN top
    layers, conceal, init = _stack(mode * 13 + int(opacity * 100), 3)
    modes = (0, mode, 2)
    opac = np.array([1.0, opacity, 0.6], np.float32)
    c = conceal if use_conceal else None
    i = init if use_init else None
    ref = np.asarray(jcomp.composite_stack_static(layers, modes, opac, c, i))
    out = tcomp.composite_stack_static(_t(layers), modes, opac,
                                       None if c is None else _t(c),
                                       None if i is None else _t(i))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("seed", range(3))
def test_traced_composite_stack_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    n = 9
    layers, conceal, init = _stack(200 + seed, n)
    modes = rng.integers(0, 25, n).astype(np.int32)
    opac = rng.choice(np.array(OPACITIES + (0.8,), np.float32), n)
    visibles = rng.random(n) < 0.6
    ref = np.asarray(jcomp.composite_stack(jnp.asarray(layers), jnp.asarray(modes),
                                           jnp.asarray(opac), jnp.asarray(visibles),
                                           jnp.asarray(conceal), jnp.asarray(init)))
    out = tcomp.composite_stack(_t(layers), torch.from_numpy(modes), torch.from_numpy(opac),
                                torch.from_numpy(visibles), _t(conceal), _t(init))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_composite_stack_with_nothing_visible_returns_init():
    layers, conceal, init = _stack(7, 3)
    out = tcomp.composite_stack(_t(layers), [1, 2, 3], [1.0] * 3, [False] * 3,
                                init=_t(init))
    np.testing.assert_array_equal(out.numpy(), init)
    ref = np.asarray(jcomp.composite_stack(layers, np.array([1, 2, 3]), np.ones(3, np.float32),
                                           np.zeros(3, bool)))
    np.testing.assert_array_equal(
        tcomp.composite_stack(_t(layers), [1, 2, 3], [1.0] * 3, [False] * 3).numpy(), ref)


def test_plain_equals_the_pallas_kernel_in_interpret_mode():
    """composite_stack_pallas (interpret mode, as tests/test_pallas.py runs
    it) against the port's entry of the same name: 26 layers, every mode."""
    rng = np.random.default_rng(0)
    n, h, w = 26, 24, 40
    layers = rng.integers(0, 256, (n, h, w, 4), np.uint8)
    modes = tuple(range(25)) + (0,)
    opac = rng.random(n).astype(np.float32)
    ref = np.asarray(jpallas(layers, modes, opac,
                             interpret=jax.default_backend() != "tpu"))
    out = kernels.composite_stack_pallas(_t(layers), modes, opac)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n", [1, 6, 40])
def test_layer_lists_with_partial_masks_equal_the_stacked_form(n):
    """A sequence of layers with None masks (the flatten's form) equals the
    stacked form with zero conceal, across a run longer than one chunk."""
    rng = np.random.default_rng(n)
    layers, conceal, init = _stack(300 + n, n)
    conceal[rng.random(n) < 0.5] = 0
    modes = rng.integers(0, 25, n)
    opac = rng.random(n).astype(np.float32)
    masks = [_t(m) if m.any() else None for m in conceal]
    ref = np.asarray(jcomp.composite_stack_static(layers, tuple(modes), opac, conceal, init))
    out = tcomp.composite_stack_static([_t(l) for l in layers], modes, opac, masks, _t(init))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_composite_pair_is_blend_u8():
    layers, _, _ = _stack(9, 2)
    ref = np.asarray(jcomp.composite_pair(jnp.asarray(layers[0]), jnp.asarray(layers[1]), 16, 0.4))
    out = tcomp.composite_pair(_t(layers[0]), _t(layers[1]), 16, 0.4)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kernel_wrapper_takes_the_plain_version_only_on_the_cpu():
    layers, _, _ = _stack(10, 2)
    before = kernels.composite_stack_kernel.launches
    out = kernels.composite_stack_kernel(_t(layers), (3, 4), (1.0, 0.5))
    assert kernels.composite_stack_kernel.launches == before  # no launch on the CPU
    np.testing.assert_array_equal(
        out.numpy(), kernels.composite_stack_plain(_t(layers), (3, 4), (1.0, 0.5)).numpy())
    with pytest.raises(ValueError, match="no layers"):
        kernels.composite_stack_kernel([], (), ())


def test_unit_table_is_the_blends_own_divide():
    """K-composite converts u8 -> f32 through a 256-entry table: each entry
    must carry the bits of the divide that blend_u8 (here and in the JAX
    package) computes."""
    from paintfe_tpu_torch.utils.quant import ieee_div

    table = kernels.composite_unit_table()
    codes = np.arange(256, dtype=np.uint8)
    assert table.dtype == np.float32 and table.shape == (256,)
    np.testing.assert_array_equal(
        table.view(np.uint32), ieee_div(_t(codes).float(), 255.0).numpy().view(np.uint32))
    ref = np.asarray(jnp.asarray(codes).astype(jnp.float32) / 255.0)
    np.testing.assert_array_equal(table.view(np.uint32), ref.view(np.uint32))


def test_a_reciprocal_multiply_is_not_the_unit_table():
    """Why the table holds divides: x * (1 / 255) in f32 rounds 126 of the
    256 values differently from x / 255."""
    x = np.arange(256, dtype=np.float32)
    product = x * (np.float32(1.0) / np.float32(255.0))
    assert int((product != kernels.composite_unit_table()).sum()) == 126


@pytest.mark.parametrize("mode", [0, 1, 7, 13, 14, 16, 19, 21])
def test_table_lookup_blend_equals_blend_u8(mode):
    """blend_u8 with its two conversions replaced by lookups in the unit
    table (what K-composite does) gives blend_u8's bytes."""
    from paintfe_tpu_torch.core import blend as tblend

    layers, _, _ = _stack(mode + 50, 2)
    base, top = _t(layers[0]), _t(layers[1])
    want = tblend.blend_u8(base, top, mode, 0.7)
    table = torch.from_numpy(kernels.composite_unit_table())
    base_f, top_f = table[base.long()], table[top.long()]
    blended = tblend._branch(tblend.BlendMode(mode))(
        base_f, top_f[..., 0:3], top_f[..., 3:4] * tblend.clip_opacity(0.7))
    got = torch.where(top[..., 3:4] == 0, base, blended)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("mode", [m for m in range(25) if m not in (13, 14)])
def test_every_mixer_maps_u8_pairs_into_zero_or_2_pow_minus_24_to_1(mode):
    """What K-composite's shared reciprocal and its clamp-free quantisation
    rest on: over all 65536 u8 (base, top) pairs a mixer gives 0 or a value
    in [2^-24, 1], never a negative one and never one above 1."""
    from paintfe_tpu_torch.core import blend as tblend

    v = torch.from_numpy(kernels.composite_unit_table())
    b, t = torch.meshgrid(v, v, indexing="ij")
    mixed = tblend._RGB_MIXERS[tblend.BlendMode(mode)](b, t)
    assert float(mixed.min()) >= 0.0 and float(mixed.max()) <= 1.0
    positive = mixed[mixed > 0]
    assert positive.numel() and float(positive.min()) >= 2.0 ** -24
    # and the JAX package's mixer gives the same values
    from paintfe_tpu.core import blend as jblend

    ref = np.asarray(jblend._RGB_MIXERS[jblend.BlendMode(mode)](jnp.asarray(b.numpy()),
                                                                jnp.asarray(t.numpy())))
    np.testing.assert_array_equal(mixed.numpy().view(np.uint32),
                                  np.broadcast_to(ref, mixed.shape).view(np.uint32))
