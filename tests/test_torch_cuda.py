"""The port's CUDA kernels on the card: each against its plain version on
the same device, tolerance 0.  Marked `cuda`; every test skips when no
CUDA device is present (the CPU test run), and runs on the card with

    python -m pytest tests/test_torch_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from paintfe_tpu_torch.core.blend import BlendMode, blend_u8
from paintfe_tpu_torch.ops import kernels
from paintfe_tpu_torch.ops import transform as tfm
from paintfe_tpu_torch.ops import warp_kernel
from paintfe_tpu_torch.ops.effects import distort
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


# every network radius and the first counting one, on images smaller than
# the window, widths and heights that are not a multiple of the 128 x 16
# tile, and a batch of 3
@pytest.mark.parametrize("r", range(1, kernels.MEDIAN_NETWORK_MAX_R + 2))
@pytest.mark.parametrize("shape", [(1, 1), (2, 7), (5, 3), (37, 53), (130, 257),
                                   (3, 45, 70)])
def test_median_kernel_equals_plain(dev, shape, r):
    img = _img(shape, 9, dev)
    before = kernels.median_kernel.launches
    out = kernels.median_kernel(img, r)
    assert kernels.median_kernel.launches == before + 1
    assert torch.equal(out, kernels.median_plain(img, r))


# the counting routes: staged up to r = 104, global past it
@pytest.mark.parametrize("r", [40, 104, 105, 110])
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (3, 45, 70)])
def test_median_counting_routes_equal_plain(dev, shape, r):
    img = _img(shape, 10, dev)
    assert torch.equal(kernels.median_kernel(img, r), kernels.median_plain(img, r))


def _blur_limit_sigmas():
    """Sigmas whose radius is the last of the short tile, the first of the
    long one, the last with its source rows staged at once, the first
    staged in chunks, the last tiled one and the first split one."""
    radii = range(300)
    th = kernels.BLUR_TILE_H
    short = kernels.BLUR_SHORT_MAX_R
    chunked = next(r for r in radii if kernels.blur_chunk_rows(th, r) < th + 2 * r)
    split = next(r for r in radii if kernels.blur_tile_rows(r) == 0)
    return [(r - 0.5) / 3 for r in (short, short + 1, chunked - 1, chunked, split - 1, split)]


@pytest.mark.parametrize("sigma", _blur_limit_sigmas())
@pytest.mark.parametrize("shape", [(37, 53), (3, 70, 45)])
def test_blur_kernel_at_tile_limits(dev, shape, sigma):
    img = _img(shape, 11, dev)
    assert torch.equal(kernels.gaussian_blur_fused(img, sigma),
                       kernels.gaussian_blur_plain(img, sigma))


def _fields(h, w, dev):
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    g = torch.Generator().manual_seed(3)
    return {
        "identity": (xx, yy),
        "const_shift": (xx - 7.25, yy + 3.5),
        "swirl": (xx - 4 * torch.sin(yy / 13.0), yy - 4 * torch.cos(xx / 17.0)),
        "deep_oob": (xx - 60.0, yy - 60.0),
        "random": (torch.rand((h, w), generator=g) * (w + 24) - 12,
                   torch.rand((h, w), generator=g) * (h + 24) - 12),
    }


@pytest.mark.parametrize("mode", ["zero", "clamp"])
@pytest.mark.parametrize("name", ["identity", "const_shift", "swirl", "deep_oob", "random"])
def test_warp_kernel_equals_plain(dev, name, mode):
    src = _img((2, 64, 280), 10, dev)
    sx, sy = (v.contiguous().to(dev) for v in _fields(64, 280, dev)[name])
    before = warp_kernel.gather_bilinear_u8.launches
    out = warp_kernel.gather_bilinear_u8(src, sx, sy, mode)
    assert warp_kernel.gather_bilinear_u8.launches == before + 1
    assert torch.equal(out, warp_kernel.gather_bilinear_plain(src, sx, sy, mode))
    assert torch.equal(out[1], warp_kernel.gather_bilinear_u8(src[1].contiguous(), sx, sy, mode))


@pytest.mark.parametrize("amount", [-1.0, -0.3, 0.5, 1.0])
def test_bulge_on_the_card_equals_the_cpu(dev, amount):
    img = _img((2, 61, 90), 11, dev)
    assert torch.equal(distort.bulge(img, amount).cpu(), distort.bulge(img.cpu(), amount))


def test_warp_displacement_on_the_card_equals_the_cpu(dev):
    src = _img((40, 52), 12, "cpu")
    field = torch.from_numpy(
        (np.random.default_rng(12).standard_normal((40, 52, 2)) * 6).astype(np.float32))
    assert torch.equal(tfm.warp_displacement(src.to(dev), field).cpu(),
                       tfm.warp_displacement(src, field))


def test_spatial_kernels_refuse_bad_tensors(dev):
    img = _img((16, 20), 13, dev)
    f = torch.zeros((16, 20), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.median_kernel(img.transpose(0, 1), 2)
    with pytest.raises(ValueError, match="f32"):
        warp_kernel.gather_bilinear_u8(img, f.double(), f)
    with pytest.raises(ValueError, match="f32"):
        warp_kernel.gather_bilinear_u8(img, f.cpu(), f)
    with pytest.raises(ValueError, match="differ"):
        warp_kernel.gather_bilinear_u8(img, f, f[:8].contiguous())


def test_spatial_run_batch_on_the_card_equals_the_cpu(dev):
    ops = pipeline.trace_script("apply_blur(2.0); apply_median(2); apply_bulge(0.5); "
                                "apply_levels(10.0, 245.0, 1.1);")
    images = _img((3, 40, 56), 14, "cpu").numpy()
    assert np.array_equal(pipeline.run_batch(images, ops, dev),
                          pipeline.run_batch(images, ops, "cpu"))


def _stack(n, shape, seed, dev):
    rng = np.random.default_rng(seed)
    layers = rng.integers(0, 256, (n,) + tuple(shape) + (4,), np.uint8)
    layers[:, :3, :, 3] = 0
    layers[:, 3:6, :, 3] = 255
    conceal = rng.integers(0, 256, (n,) + tuple(shape), np.uint8)
    init = rng.integers(0, 256, tuple(shape) + (4,), np.uint8)
    return (torch.from_numpy(layers).to(dev), torch.from_numpy(conceal).to(dev),
            torch.from_numpy(init).to(dev))


@pytest.mark.parametrize("opacity", [0.0, 0.37, 1.0, 1.5])
@pytest.mark.parametrize("mode", range(25))
def test_composite_kernel_equals_plain_every_mode(dev, mode, opacity):
    layers, conceal, init = _stack(3, (37, 53), mode, dev)
    modes, opac = (0, mode, 16), (1.0, opacity, 0.6)
    for c, i in ((None, None), (conceal, None), (None, init), (conceal, init)):
        before = kernels.composite_stack_kernel.launches
        out = kernels.composite_stack_kernel(layers, modes, opac, c, i)
        assert kernels.composite_stack_kernel.launches == before + 1
        assert torch.equal(out, kernels.composite_stack_plain(layers, modes, opac, c, i))


@pytest.mark.parametrize("n", [1, 6, 40])
def test_composite_kernel_folds_long_stacks_in_chunks(dev, n):
    layers, conceal, init = _stack(n, (45, 70), 100 + n, dev)
    rng = np.random.default_rng(n)
    modes = rng.integers(0, 25, n).tolist()
    opac = rng.random(n).astype(np.float32)
    masks = [m if k % 2 else None for k, m in enumerate(conceal)]
    before = kernels.composite_stack_kernel.launches
    out = kernels.composite_stack_kernel(list(layers), modes, opac, masks, init)
    assert kernels.composite_stack_kernel.launches == before + -(-n // kernels.COMPOSITE_CHUNK)
    assert torch.equal(out, kernels.composite_stack_plain(list(layers), modes, opac, masks, init))


def test_composite_kernel_refuses_bad_tensors(dev):
    layers, conceal, _ = _stack(2, (16, 20), 5, dev)
    with pytest.raises(ValueError, match="conceal"):
        kernels.composite_stack_kernel(layers, (0, 1), (1, 1), conceal[:, :8])
    with pytest.raises(ValueError, match="differs"):
        kernels.composite_stack_kernel([layers[0], layers[1, :8].contiguous()], (0, 1), (1, 1))
    with pytest.raises(ValueError, match="mode"):
        kernels.composite_stack_kernel(layers, (0, 25), (1, 1))


@pytest.mark.parametrize("sigma", [0.5, 2.0, 8.0, 25.0])
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (70, 45)])
def test_blur_pass_kernel_equals_plain(dev, shape, sigma):
    img = _img(shape, 15, dev)
    before = kernels.gaussian_blur_pass.launches
    out = kernels.gaussian_blur_pallas(img, sigma)
    assert kernels.gaussian_blur_pass.launches == before + 2
    assert torch.equal(out, kernels.gaussian_blur_pallas(img.cpu(), sigma).to(dev))
    assert torch.equal(out, kernels.gaussian_blur_plain(img, sigma))


def test_canvas_composite_on_the_card_equals_the_cpu(dev):
    from paintfe_tpu_torch.core import canvas as C
    from paintfe_tpu_torch.core import deep
    from paintfe_tpu_torch.core.device import (DeviceLayerCache, composite_device,
                                               composite_dirty_rect)

    rng = np.random.default_rng(16)
    doc = C.Canvas(width=150, height=130)
    doc.folders = [C.LayerFolder(1, "hidden", visible=False)]
    for k, mode in enumerate((0, 1, 16, None, 2, 9)):
        layer = C.Layer.new(f"L{k}", 150, 130)
        if mode is None:
            layer.content = "adjustment"
            layer.adjustment = deep.AdjustmentLayerData(kind=deep.AdjustmentKind.BRIGHTNESS_CONTRAST,
                                                        brightness=10.0, contrast=20.0)
            layer.opacity = 0.6
        else:
            layer.pixels = rng.integers(0, 256, (130, 150, 4), np.uint8)
            layer.pixels[64:128, 64:128] = 0
            layer.blend_mode = C.BlendMode(mode)
            layer.opacity = 0.7 if k == 1 else 1.0
        doc.layers.append(layer)
    doc.layers[5].folder_id = 1
    doc.layers[1].mask = rng.integers(0, 256, (130, 150), np.uint8)
    before = kernels.composite_stack_kernel.launches
    got = doc.composite(device=dev)
    assert kernels.composite_stack_kernel.launches == before + 2  # two raster runs
    want = doc.composite(device="cpu")
    assert np.array_equal(got, want)
    cache = DeviceLayerCache(dev)
    full = composite_device(doc, cache)
    assert np.array_equal(full.cpu().numpy(), want)
    px = doc.layers[2].pixels.copy()
    px[10:40, 20:90] = 9
    doc.layers[2].pixels = px
    updated = composite_dirty_rect(doc, cache, full, (20, 10, 89, 39))
    assert np.array_equal(updated.cpu().numpy(), doc.composite(device="cpu"))


@pytest.mark.parametrize("preview", [(0, "blend"), (1, "blend"), (13, "blend"),
                                     (14, "blend"), (0, "eraser"), (0, "replace")])
def test_preview_composite_on_the_card_equals_the_cpu(dev, preview):
    from paintfe_tpu_torch.core import canvas as C
    from paintfe_tpu_torch.core.device import (DeviceLayerCache, composite_device,
                                               composite_dirty_rect)

    rng = np.random.default_rng(17)
    doc = C.Canvas(width=150, height=130)
    for k, mode in enumerate((0, 16, 2)):
        layer = C.Layer.new(f"L{k}", 150, 130)
        layer.pixels = rng.integers(0, 256, (130, 150, 4), np.uint8)
        layer.blend_mode = C.BlendMode(mode)
        doc.layers.append(layer)
    doc.active_layer_index = 1
    pv = np.zeros((130, 150, 4), np.uint8)
    pv[10:60, 20:90] = rng.integers(0, 256, (50, 70, 4), np.uint8)
    doc.preview = pv
    doc.preview_blend_mode = C.BlendMode(preview[0])
    doc.preview_is_eraser = preview[1] == "eraser"
    doc.preview_replaces_layer = preview[1] == "replace"
    want = doc.composite(device="cpu")
    assert np.array_equal(doc.composite(device=dev), want)
    cache = DeviceLayerCache(dev)
    full = composite_device(doc, cache)
    assert full.device.type == "cuda"
    assert np.array_equal(full.cpu().numpy(), want)
    moved = np.zeros_like(pv)
    moved[60:100, 30:80] = rng.integers(0, 256, (40, 50, 4), np.uint8)
    doc.preview = moved
    updated = composite_dirty_rect(doc, cache, full, (10, 5, 120, 110))
    assert np.array_equal(updated.cpu().numpy(), doc.composite(device="cpu"))


def _offset_copy(t, offset):
    """A contiguous copy of `t` starting `offset` bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 32, dtype=torch.uint8, device=t.device)
    start = (-flat.data_ptr()) % 16 + offset
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# K-composite's entry takes 16-byte accesses only where every pointer of the
# launch allows: layers allocated singly (with a scalar tail where H * W is
# not a multiple of 4), a stacked tensor of odd size (its layers start 4
# bytes off), one layer, the accumulator or one conceal plane off alignment
@pytest.mark.parametrize("layout", ["single", "stacked", "layer+4", "init+8", "conceal+1",
                                    "conceal sliced"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (2, 2), (37, 53), (64, 64), (45, 70)])
def test_composite_kernel_vector_scalar_and_tail_paths(dev, shape, layout):
    n = 6
    layers, conceal, init = _stack(n, shape, 200 + shape[0], dev)
    modes, opac = (0, 1, 16, 7, 13, 2), (1.0, 0.7, 1.0, 0.37, 0.5, 0.9)
    want = kernels.composite_stack_plain(layers, modes, opac, conceal, init)
    ls, ms = [l.clone() for l in layers], [m.clone() for m in conceal]
    if layout == "stacked":
        ls, ms = layers, conceal
    elif layout == "layer+4":
        ls[3] = _offset_copy(ls[3], 4)
    elif layout == "init+8":
        init = _offset_copy(init, 8)
    elif layout == "conceal+1":
        ms[2] = _offset_copy(ms[2], 1)
    elif layout == "conceal sliced":
        wide = torch.zeros((n, shape[0] + 1, shape[1]), dtype=torch.uint8, device=dev)
        wide[:, 1:] = conceal
        ms = [w[1:] for w in wide]  # contiguous rows, W bytes past the allocation
    before = kernels.composite_stack_kernel.launches
    out = kernels.composite_stack_kernel(ls, modes, opac, ms, init)
    assert kernels.composite_stack_kernel.launches == before + 1
    assert torch.equal(out, want)


# opacities below 2^-20 leave the shared reciprocal for three __fdiv_rn
@pytest.mark.parametrize("opacity", [9.6e-7, 9.5e-7, 1e-12, 1e-30, 1e-45])
@pytest.mark.parametrize("mode", [0, 7, 13, 16, 21])
def test_composite_kernel_at_tiny_opacities(dev, mode, opacity):
    layers, conceal, init = _stack(3, (37, 53), 300 + mode, dev)
    modes, opac = (0, mode, mode), (1.0, opacity, 1.0)
    assert torch.equal(kernels.composite_stack_kernel(layers, modes, opac, conceal, init),
                       kernels.composite_stack_plain(layers, modes, opac, conceal, init))


# widths below the radius, around a group of 4 and around a segment
@pytest.mark.parametrize("sigma", [0.5, 2.0, 8.0, 25.0])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7, 8, 63, 255, 256, 257, 515, 1024, 1025])
def test_blur_pass_kernel_at_edge_widths(dev, w, sigma):
    from paintfe_tpu_torch.ops.filters import gaussian_kernel

    rng = np.random.default_rng(w)
    x = torch.from_numpy((rng.random((2, 3, w)) * 300 - 20).astype(np.float32)).to(dev)
    taps = gaussian_kernel(sigma)
    assert kernels.pass_route(w, len(taps) // 2) == "staged"
    before = kernels.gaussian_blur_pass.launches
    out = kernels.gaussian_blur_pass(x, taps)
    assert kernels.gaussian_blur_pass.launches == before + 1
    assert torch.equal(out, kernels.gaussian_blur_pass_plain(x, taps))


@pytest.mark.parametrize("preview", [None, (0, "blend"), (14, "blend"), (0, "eraser"),
                                     (0, "replace")])
def test_flatten_with_adjustment_and_empty_tiles_on_the_card_equals_the_cpu(dev, preview):
    """Canvas.composite, composite_device and composite_dirty_rect with the
    active-tile mask built on the card: an invert adjustment layer, tiles
    empty in every layer, one tile only the active layer fills, one only the
    preview fills."""
    from paintfe_tpu_torch.core import canvas as C
    from paintfe_tpu_torch.core import deep
    from paintfe_tpu_torch.core.device import (DeviceLayerCache, composite_device,
                                               composite_dirty_rect)

    rng = np.random.default_rng(18)
    doc = C.Canvas(width=150, height=130)
    for k, mode in enumerate((0, 1, None, 2)):
        layer = C.Layer.new(f"L{k}", 150, 130)
        if mode is None:
            layer.content = "adjustment"
            layer.adjustment = deep.AdjustmentLayerData(kind=deep.AdjustmentKind.INVERT)
            layer.opacity = 0.6
        else:
            layer.pixels = rng.integers(0, 256, (130, 150, 4), np.uint8)
            layer.pixels[64:128, 64:128] = 0  # empty unless the preview fills it
            layer.pixels[128:, 0:64] = 0  # empty in every layer
            layer.pixels[0:64, 128:] = 180 if k == 3 else 0  # the active layer's alone
            layer.blend_mode = C.BlendMode(mode)
        doc.layers.append(layer)
    doc.active_layer_index = 3
    if preview is not None:
        pv = np.zeros((130, 150, 4), np.uint8)
        pv[10:60, 20:90] = rng.integers(0, 256, (50, 70, 4), np.uint8)
        pv[70:90, 100:120] = 200
        doc.preview = pv
        doc.preview_blend_mode = C.BlendMode(preview[0])
        doc.preview_is_eraser = preview[1] == "eraser"
        doc.preview_replaces_layer = preview[1] == "replace"
    want = doc.composite(device="cpu")
    assert (want[128:, 0:64] == 0).all()
    assert np.array_equal(doc.composite(device=dev), want)
    cache = DeviceLayerCache(dev)
    full = composite_device(doc, cache)
    assert full.device.type == "cuda"
    assert np.array_equal(full.cpu().numpy(), want)
    px = doc.layers[1].pixels.copy()
    px[30:120, 50:140] = rng.integers(0, 256, (90, 90, 4), np.uint8)
    px[64:128, 64:128] = 0
    doc.layers[1].pixels = px
    updated = composite_dirty_rect(doc, cache, full, (50, 30, 139, 119))
    assert np.array_equal(updated.cpu().numpy(), doc.composite(device="cpu"))


def _chain_limit_sigmas():
    """Sigmas whose radius takes each of K-chain's tile widths (4 sums a
    thread to BLUR_SHORT_MAX_R, then 8), its last tiled radius and the one
    after it (K-blur's tile, then the tail), and K-blur's last tiled radius
    and its first split one."""
    radii = range(300)
    short = kernels.BLUR_SHORT_MAX_R
    chain = next(r for r in radii if kernels.chain_tile_rows(r) == 0)
    split = next(r for r in radii if kernels.blur_tile_rows(r) == 0)
    return [(r - 0.5) / 3 for r in (1, short, short + 1, chain - 1, chain, split - 1, split)]


# opacities on both sides of div3's shared reciprocal (2^-20) and the ends
@pytest.mark.parametrize("opacity", [0.6, 2.0 ** -20, 2.0 ** -21, 1.0])
@pytest.mark.parametrize("sigma", _chain_limit_sigmas())
def test_chain_kernel_at_tile_limits_and_opacities(dev, sigma, opacity):
    img, ov = _img((70, 45), 12, dev), _img((70, 45), 13, dev)
    ov[:6, :, 3] = 0
    ov[-3:, :, 3] = 255
    img[20:23, :, 3] = 0
    before = fused_chain_kernel.launches
    out = fused_chain_kernel(img, ov, sigma=sigma, blend_opacity=opacity)
    assert fused_chain_kernel.launches == before + 1
    assert torch.equal(out, fused_chain(img, ov, sigma=sigma, blend_opacity=opacity))


@pytest.mark.parametrize("opacity", [0.6, 2.0 ** -20, 2.0 ** -21, 1.0])
def test_chain_quotients_equal_correctly_rounded_divides(dev, opacity):
    """pfe_chain_div_check: over every u8 (base, base alpha, overlay,
    overlay alpha), no quotient of the chain's soft-light tail differs from
    __fdiv_rn, on either side of the shared reciprocal's opacity limit."""
    import ctypes

    from paintfe_tpu_torch.utils.cuda_build import check, load_library

    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    check(load_library().pfe_chain_div_check(ctypes.c_float(opacity), counts.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream),
          "pfe_chain_div_check")
    differ, compared = counts.tolist()
    assert differ == 0 and compared > 3 * 255 * 2 ** 23


def _field_offset(t, offset):
    """A contiguous copy of the f32 tensor `t` starting `offset` bytes (a
    multiple of 4) past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=torch.float32, device=t.device)
    start = (-flat.data_ptr()) % 16 // 4 + offset // 4
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# K-warp's paths (ops/warp_kernel.warp_split): W a multiple of 4 with
# aligned fields (vector), W = 511 and 3838 (scalar with a tail of 3 and
# 2), 3841 (a tail of 1), a field 4 bytes off a 16-byte boundary (scalar),
# and a batch sharing one field
@pytest.mark.parametrize("mode", ["zero", "clamp"])
@pytest.mark.parametrize("w,layout", [(512, "aligned"), (511, "aligned"), (3838, "aligned"),
                                      (3841, "aligned"), (512, "sx+4"), (512, "sy+8"),
                                      (3840, "batch")])
def test_warp_kernel_vector_scalar_and_tail_paths(dev, w, layout, mode):
    h = 9
    batch = (3,) if layout == "batch" else ()
    src = _img(batch + (h + 5, w - 3), 14, dev)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    g = torch.Generator().manual_seed(5)
    sx = (xx * 0.997 - 1.5 + torch.rand((h, w), generator=g) * 3).to(dev)
    sy = (yy * 1.1 - 2.0 + torch.rand((h, w), generator=g) * 2).to(dev)
    if layout == "sx+4":
        sx = _field_offset(sx, 4)
    if layout == "sy+8":
        sy = _field_offset(sy, 8)
    before = warp_kernel.gather_bilinear_u8.launches
    out = warp_kernel.gather_bilinear_u8(src, sx, sy, mode)
    assert warp_kernel.gather_bilinear_u8.launches == before + 1
    assert torch.equal(out, warp_kernel.gather_bilinear_plain(src, sx, sy, mode))
    path = warp_kernel.warp_split(w, sx.data_ptr(), sy.data_ptr(), out.data_ptr())[0]
    assert path == ("vector" if layout in ("aligned", "batch") and w % 4 == 0 else "scalar")


# every op of the batched table but the ones already held above, at small
# sizes: the card's bytes equal the CPU's (ROADMAP C2: host-built fields)
_EFFECT_OPS = [
    ("apply_box_blur", (3.0,)), ("apply_motion_blur", (30.0, 4.0)),
    ("apply_sharpen", (1.5,)), ("apply_reduce_noise", (25.0,)),
    ("apply_desaturate", ()), ("apply_exposure", (0.7,)), ("apply_noise", (30.0, True)),
    ("apply_noise", (30.0, False)), ("apply_pixelate", (5,)), ("apply_crystallize", (6.0,)),
    ("apply_twist", (120.0,)), ("apply_glow", (3.0, 1.7)), ("apply_vignette", (0.6, 0.8)),
    ("apply_halftone", (6.0,)), ("apply_ink", (50.0, 30.0)), ("apply_oil_painting", (3,)),
]


@pytest.mark.parametrize("name,args", _EFFECT_OPS)
@pytest.mark.parametrize("shape", [(37, 53), (3, 64, 96)])
def test_effect_ops_on_the_card_equal_the_cpu(dev, name, args, shape):
    img = _img(shape, 7, dev)
    op = pipeline._OP_TABLE[name]
    counts = (kernels.gaussian_blur_fused.launches, warp_kernel.gather_bilinear_u8.launches)
    out = op(img, *args)
    launched = (kernels.gaussian_blur_fused.launches - counts[0],
                warp_kernel.gather_bilinear_u8.launches - counts[1])
    # one K-blur launch for sharpen and glow, one K-warp launch for twist,
    # for a frame and for a batch alike
    assert launched == ((1, 0) if name in ("apply_sharpen", "apply_glow") else
                        (0, 1) if name == "apply_twist" else (0, 0))
    assert torch.equal(out.cpu(), op(img.cpu(), *args))


@pytest.mark.parametrize("filt", ["nearest", "bilinear", "bicubic", "lanczos3"])
def test_resize_through_a_card_context_equals_the_cpu(dev, filt):
    from paintfe_tpu_torch.scripting import engine

    img = _img((45, 70), 8, "cpu").numpy()
    src = f'resize_image(33, 61, "{filt}"); resize_canvas(50, 40, "center"); apply_twist(30.0);'
    on_card = engine.execute_script_sync(src, img, 70, 45, None, rng_seed=1, device=dev)
    on_cpu = engine.execute_script_sync(src, img, 70, 45, None, rng_seed=1, device="cpu")
    np.testing.assert_array_equal(on_card[0], on_cpu[0])
    assert on_card[1:3] == on_cpu[1:3] == (50, 40)


# -- threads and streams (K-blur's constant taps, the cached device tables) --

C7_SCRIPTS = ("apply_blur(1.0); apply_twist(30.0); apply_blur(4.0);",
              "apply_blur(6.0); apply_twist(-45.0); apply_blur(0.5);")


def test_async_workers_on_two_streams_equal_their_plain_versions(dev):
    """Two execute_script_async workers at once, each under its own CUDA
    stream, with different blur sigmas and a twist, over 20 rounds: every
    result equals the same script on the CPU (the plain versions)."""
    from paintfe_tpu_torch.scripting import execute_script_async, execute_script_sync

    img = _img((270, 480), 11, "cpu").numpy()
    want = [execute_script_sync(s, img, 480, 270, device="cpu")[0] for s in C7_SCRIPTS]
    streams = [torch.cuda.Stream(dev) for _ in C7_SCRIPTS]
    before = kernels.gaussian_blur_fused.launches
    for _ in range(20):
        runs = [execute_script_async(s, img, 480, 270, device=dev, stream=st)
                for s, st in zip(C7_SCRIPTS, streams)]
        for (thread, q), expected in zip(runs, want):
            thread.join(120)
            msgs = []
            while not q.empty():
                msgs.append(q.get())
            assert msgs[-1].kind == "completed", msgs[-1].payload
            np.testing.assert_array_equal(msgs[-1].payload[0], expected)
    assert kernels.gaussian_blur_fused.launches - before == 20 * 4


def test_blur_from_two_threads_on_two_streams_equals_plain(dev):
    """K-blur launched from two host threads on two streams with different
    sigmas, each call queued behind a long one on its own stream: each
    result equals gaussian_blur_plain."""
    import threading

    imgs = [_img((2, 540, 960), 12 + k, dev) for k in range(2)]
    sigmas = (1.0, 7.0)
    want = [kernels.gaussian_blur_plain(i, s) for i, s in zip(imgs, sigmas)]
    outs = [[], []]

    def worker(k):
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            for _ in range(20):
                kernels.gaussian_blur_fused(imgs[k], 25.0)  # a long launch ahead
                outs[k].append(kernels.gaussian_blur_fused(imgs[k], sigmas[k]))
        stream.synchronize()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in range(2):
        for out in outs[k]:
            assert torch.equal(out, want[k])


def test_cached_tables_are_read_safely_from_another_stream(dev):
    """K-chain's taps and levels table (and K-pass's taps), cached on one
    stream, read by launches on another: equal to the plain versions."""
    img, ov = _img((65, 97), 13, dev), _img((65, 97), 14, dev)
    fused_chain_kernel(img, ov, sigma=3.0)  # fills the caches on this stream
    kernels.gaussian_blur_pass(img.permute(2, 0, 1).float().contiguous(),
                               kernels.gaussian_kernel(3.0))
    other = torch.cuda.Stream(dev)
    with torch.cuda.stream(other):
        out = fused_chain_kernel(img, ov, sigma=3.0)
        planar = img.permute(2, 0, 1).float().contiguous()
        passed = kernels.gaussian_blur_pass(planar, kernels.gaussian_kernel(3.0))
    other.synchronize()
    assert torch.equal(out, fused_chain(img, ov, sigma=3.0))
    assert torch.equal(passed, kernels.gaussian_blur_pass_plain(planar,
                                                                kernels.gaussian_kernel(3.0)))


# -- the inputs path: text layers, 16-bit and .pdn inputs on the card ----------

@pytest.mark.parametrize("mode", [0, 1, 2])
def test_outline_on_the_card_equals_the_cpu(dev, mode):
    from paintfe_tpu_torch.ops.effects import render

    img = _img((61, 83), 15, "cpu").numpy()
    img[..., 3] = np.where(np.arange(83)[None, :] % 17 < 9, img[..., 3], 0)
    on_card = render.outline(img, 3, (200, 10, 60, 220), mode, True, device=dev)
    assert on_card.is_cuda
    assert torch.equal(on_card.cpu(), render.outline(img, 3, (200, 10, 60, 220), mode,
                                                     True, device="cpu"))


def test_text_layer_on_the_card_equals_the_cpu(dev):
    from paintfe_tpu_torch.ops import text_layer as tl

    td = tl.make_text_layer_data("Card text", 10, 12, size=30, color=(250, 250, 250, 255))
    td.effects.outline = tl.OutlineEffect((255, 0, 0, 255), 2.0)
    td.effects.shadow = tl.ShadowEffect((0, 0, 0, 200), 4.0, 5.0, 6.0, 1.5)
    before = kernels.gaussian_blur_fused.launches
    on_card = td.rasterize(240, 90, device=dev)
    assert kernels.gaussian_blur_fused.launches == before + 1  # the shadow's blur
    td.mark_dirty()
    np.testing.assert_array_equal(on_card, td.rasterize(240, 90, device="cpu"))


def test_cli_on_deep_pdn_and_text_inputs_on_the_card_equals_the_cpu(dev, tmp_path):
    import chip_smoke
    from paintfe_tpu_torch import cli
    from paintfe_tpu_torch.core.canvas import Canvas, Layer
    from paintfe_tpu_torch.io import deep_export
    from paintfe_tpu_torch.io.pfe import save_pfe
    from paintfe_tpu_torch.ops import text_layer as tl

    rng = np.random.default_rng(16)
    h, w = 90, 130
    (tmp_path / "deep.png").write_bytes(chip_smoke.png16_bytes(
        rng.integers(0, 65536, (h, w, 4), np.uint16)))
    deep_export.write_tiff16(tmp_path / "deep16.tif", w, h,
                             rng.integers(0, 65536, (h, w, 4), np.uint16), "deflate")
    (tmp_path / "doc.pdn").write_bytes(chip_smoke.pdn_bytes(
        [dict(name=f"l{k}", pixels=rng.integers(0, 256, (h, w, 4), np.uint8),
              blend=("Normal", "Multiply", "Screen")[k]) for k in range(3)], w, h))
    doc = Canvas.new(w, h)
    doc.layers[0].pixels = rng.integers(0, 256, (h, w, 4), np.uint8)
    text = Layer.new("t", w, h)
    text.content = "text"
    text.text_data = tl.make_text_layer_data("Hi", 5, 5, size=28, color=(255, 255, 0, 255))
    text.text_data.effects.shadow = tl.ShadowEffect(blur_radius=6.0)
    doc.layers.append(text)
    save_pfe(doc, str(tmp_path / "text.pfe"))
    (tmp_path / "fx.rhai").write_text("apply_blur(2.0);")
    for fmt in ("png", "tiff"):
        common = ["-i", str(tmp_path / "deep*"), str(tmp_path / "doc.pdn"),
                  str(tmp_path / "text.pfe"), "-s", str(tmp_path / "fx.rhai"), "-f", fmt]
        assert cli.main(common + ["--output-dir", str(tmp_path / f"c{fmt}"), "--device",
                                  "cuda"]) == 0
        assert cli.main(common + ["--output-dir", str(tmp_path / f"p{fmt}"), "--device",
                                  "cpu"]) == 0
        names = sorted(p.name for p in (tmp_path / f"p{fmt}").iterdir())
        assert len(names) == 4
        for name in names:
            assert ((tmp_path / f"c{fmt}" / name).read_bytes()
                    == (tmp_path / f"p{fmt}" / name).read_bytes()), name


# -- the document-editing path: K-warp under apply_affine, K-composite under
# merge_down and the LOD, the wand's plain torch on the card ------------------

AFFINE_CASES = [dict(rotation_z=17.5), dict(rotation_z=-30.0), dict(rotation_z=45.0),
                dict(rotation_z=90.0), dict(rotation_z=10.0, scale=1.7, offset=(3.5, -2.0)),
                dict(rotation_z=5.0, canvas_size=(150, 70)),
                dict(rotation_x=80.0, rotation_y=30.0), dict(rotation_y=-85.0, scale=0.5)]


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
@pytest.mark.parametrize("case", AFFINE_CASES, ids=str)
def test_apply_affine_on_the_card_equals_the_cpu(dev, case, interpolation):
    img = _img((3, 61, 97), 20, "cpu")
    before = warp_kernel.gather_bilinear_u8.launches
    got = tfm.apply_affine(img, interpolation=interpolation, device=dev, **case)
    assert warp_kernel.gather_bilinear_u8.launches == before + (interpolation != "nearest")
    want = tfm.apply_affine(img, interpolation=interpolation, device="cpu", **case)
    assert torch.equal(got.cpu(), want)


def _edit_doc(seed, h=72, w=96):
    import chip_smoke

    return chip_smoke.editing_document(np.random.default_rng(seed), h, w)


@pytest.mark.parametrize("degrees,interpolation", [(17.5, "bilinear"), (-30.0, "nearest"),
                                                   (90.0, "bilinear")])
def test_rotate_canvas_arbitrary_on_the_card_equals_the_cpu(dev, degrees, interpolation):
    from paintfe_tpu_torch.ops import canvas_transform as ct

    a, b = _edit_doc(21), _edit_doc(21)
    before = warp_kernel.gather_bilinear_u8.launches
    ct.rotate_canvas_arbitrary(a, degrees, interpolation, device=dev)
    # every layer and mask of the canvas in one batched launch
    assert warp_kernel.gather_bilinear_u8.launches == before + (interpolation != "nearest")
    ct.rotate_canvas_arbitrary(b, degrees, interpolation, device="cpu")
    for x, y in zip(a.layers, b.layers):
        assert np.array_equal(x.pixels, y.pixels)
        assert (x.mask is None and y.mask is None) or np.array_equal(x.mask, y.mask)


@pytest.mark.parametrize("mode", list(BlendMode))
@pytest.mark.parametrize("opacity", [0.37, 1.0])
def test_merge_down_on_the_card_equals_the_cpu(dev, mode, opacity):
    from paintfe_tpu_torch.ops import canvas_ops

    a, b = _edit_doc(22), _edit_doc(22)
    for doc in (a, b):
        doc.layers[2].blend_mode, doc.layers[2].opacity = mode, opacity
    before = kernels.composite_stack_kernel.launches
    canvas_ops.merge_down(a, 2, device=dev)
    assert kernels.composite_stack_kernel.launches == before + 1
    canvas_ops.merge_down(b, 2, device="cpu")
    assert np.array_equal(a.layers[1].pixels, b.layers[1].pixels)


def test_composite_lod_and_viewport_on_the_card_equal_the_cpu(dev):
    from paintfe_tpu_torch.ops import canvas_transform as ct

    doc = _edit_doc(23, 1100, 1300)
    assert np.array_equal(ct.composite_lod(doc, device=dev), ct.composite_lod(doc, device="cpu"))
    rect = (100, 200, 900, 1000)
    assert np.array_equal(ct.composite_viewport(doc, rect, device=dev),
                          ct.composite_viewport(doc, rect, device="cpu"))


WAND_CARD_CASES = [(60, 45, 12.0, True, True, True, "perceptual"),
                   (60, 45, 12.0, True, False, False, "perceptual"),
                   (10, 10, 30.0, False, True, False, "perceptual"),
                   (60, 45, 20.0, True, True, False, "legacy")]


@pytest.mark.parametrize("case", WAND_CARD_CASES, ids=str)
def test_magic_wand_on_the_card_equals_the_cpu(dev, case):
    from paintfe_tpu_torch.ops import fill

    img = _edit_doc(24).layers[2].pixels
    assert np.array_equal(fill.magic_wand_mask(img, *case, device=dev),
                          fill.magic_wand_mask(img, *case, device="cpu"))
    for target in (img[50, 60], (0, 0, 0, 0)):
        t = torch.from_numpy(img)
        assert torch.equal(fill.perceptual_distance_map(t.to(dev), target).cpu(),
                           fill.perceptual_distance_map(t, target))


def test_bucket_fill_and_flood_select_on_the_card_equal_the_cpu(dev):
    from paintfe_tpu_torch.ops import color_removal, fill

    img = _edit_doc(25).layers[1].pixels
    assert np.array_equal(fill.bucket_fill(img, 60, 45, (9, 8, 7, 255), 20.0, device=dev),
                          fill.bucket_fill(img, 60, 45, (9, 8, 7, 255), 20.0, device="cpu"))
    assert np.array_equal(color_removal.flood_select(img, 60, 45, 15.0, device=dev),
                          color_removal.flood_select(img, 60, 45, 15.0, device="cpu"))


def test_document_path_on_the_card_equals_the_cpu(dev, tmp_path):
    """chip_smoke's document path at 128x96: every step on the card against
    the same step on the CPU, then undo to the start and redo to the end."""
    import chip_smoke
    from paintfe_tpu_torch.core.project import Project
    from paintfe_tpu_torch.io.pfe import save_pfe
    from paintfe_tpu_torch.ops.clipboard import Clipboard

    src = tmp_path / "doc.pfe"
    save_pfe(chip_smoke.editing_document(np.random.default_rng(9), 96, 128), str(src))
    card, host = Project.open(src, device=dev), Project.open(src, device="cpu")
    clips = Clipboard(), Clipboard()
    for (name, step), (_, cpu_step) in zip(
            chip_smoke.document_steps(chip_smoke.port_modules(), {"device": dev}),
            chip_smoke.document_steps(chip_smoke.port_modules(), {"device": "cpu"})):
        step(card, clips[0])
        cpu_step(host, clips[1])
        assert chip_smoke.document_differences(card.canvas, host.canvas) == [], name
    while card.history.undo(card.canvas):
        pass
    assert chip_smoke.document_differences(card.canvas, Project.open(src, "cpu").canvas) == []
    while card.history.redo(card.canvas):
        pass
    assert chip_smoke.document_differences(card.canvas, host.canvas) == []


def test_hsl_round_trip_on_the_card_equals_the_cpu(dev):
    from paintfe_tpu_torch.core import colorspace

    rgb = torch.from_numpy(np.random.default_rng(26).integers(0, 256, (3, 70000))
                           .astype(np.float32) / np.float32(255.0))
    rgb[:, :256] = torch.arange(256) / 255.0
    host = colorspace.rgb_to_hsl(*rgb)
    card = colorspace.rgb_to_hsl(*rgb.to(dev))
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(colorspace.hsl_to_rgb(*card), colorspace.hsl_to_rgb(*host)):
        assert torch.equal(a.cpu(), b)


def _menu_ops(h, w):
    import chip_smoke

    return chip_smoke.menu_op_table(h, w)


_MENU_NAMES = [name for name, _ in _menu_ops(8, 8)]


@pytest.mark.parametrize("shape", [(37, 53), (61, 90)])
@pytest.mark.parametrize("k", range(len(_MENU_NAMES)), ids=_MENU_NAMES)
def test_menu_op_on_the_card_equals_the_cpu(dev, k, shape):
    """Each op of the menu path (the adjustments, the menu effects, the
    Liquify and mesh warps, the gradients) at odd widths under an elliptic
    selection: the card's bytes equal the CPU's."""
    import chip_smoke

    h, w = shape
    name, fn = _menu_ops(h, w)[k]
    host = _img(shape, 30 + k, "cpu")
    mask = torch.from_numpy(chip_smoke._ellipse(h, w))
    got = fn(host.to(dev), mask.to(dev))
    assert got.is_cuda
    assert torch.equal(got.cpu(), fn(host, mask)), name


def test_band_remainder_on_the_card_equals_the_cpu(dev):
    """hue_saturation_per_band's floor-mod: torch.remainder on the card
    equals the CPU's (and so jnp.remainder, tests/test_torch_adjustments.py)
    bitwise, divisors 1 and 360."""
    x = torch.from_numpy(np.random.default_rng(27).uniform(-1000, 1000, 1 << 20)
                         .astype(np.float32))
    for d in (1.0, 360.0):
        assert torch.equal(torch.remainder(x.to(dev), d).cpu(), torch.remainder(x, d))


def _launched(fn):
    before = {f: f.launches for f in (kernels.gaussian_blur_fused, warp_kernel.gather_bilinear_u8,
                                      kernels.composite_stack_kernel)}
    fn()
    torch.cuda.synchronize()
    return {f.__name__: f.launches - n for f, n in before.items()}


def test_menu_launch_counts(dev):
    """dents, the Liquify warp and the mesh warp launch K-warp once each,
    the drop shadow K-blur once; none launches another kernel."""
    from paintfe_tpu_torch.ops.effects import render

    img = _img((61, 90), 40, dev)
    field = tfm.DisplacementField(90, 61)
    field.apply_twirl(40.0, 30.0, 20.0, 1.0)
    grid = tfm.uniform_grid(4, 3, 90, 61)
    warp_once = {"gaussian_blur_fused": 0, "gather_bilinear_u8": 1,
                 "composite_stack_kernel": 0}
    assert _launched(lambda: distort.dents(img, 8.0, 0.6, pinch=True)) == warp_once
    assert _launched(lambda: tfm.warp_displacement(img, field)) == warp_once
    assert _launched(lambda: tfm.warp_mesh_catmull_rom(img, grid, grid + 2.5, 4, 3)) \
        == warp_once
    assert _launched(lambda: render.drop_shadow(img, 4, 3, 3.0, True, (0, 0, 0, 255), 0.8)) \
        == {"gaussian_blur_fused": 1, "gather_bilinear_u8": 0, "composite_stack_kernel": 0}


def test_menu_path_on_the_card_equals_the_cpu(dev, tmp_path):
    """chip_smoke's menu path at 128x96: every step on the card against the
    same step on the CPU, then undo to the start and redo to the end."""
    import chip_smoke
    from paintfe_tpu_torch.core.history import HistoryManager
    from paintfe_tpu_torch.core.project import Project
    from paintfe_tpu_torch.io.pfe import save_pfe

    src = tmp_path / "doc.pfe"
    save_pfe(chip_smoke.editing_document(np.random.default_rng(11), 96, 128), str(src))
    card, host = Project.open(src, device=dev), Project.open(src, device="cpu")
    card.history = HistoryManager(max_entries=100, memory_limit_bytes=1 << 30)
    states = {}, {}
    for (name, step), (_, cpu_step) in zip(
            chip_smoke.menu_steps(chip_smoke.menu_modules(), {"device": dev}),
            chip_smoke.menu_steps(chip_smoke.menu_modules(), {"device": "cpu"})):
        step(card, states[0])
        cpu_step(host, states[1])
        assert chip_smoke.document_differences(card.canvas, host.canvas) == [], name
    assert np.array_equal(states[0]["histogram"], states[1]["histogram"])
    while card.history.undo(card.canvas):
        pass
    assert chip_smoke.document_differences(card.canvas, Project.open(src, "cpu").canvas) == []
    while card.history.redo(card.canvas):
        pass
    assert chip_smoke.document_differences(card.canvas, host.canvas) == []


# -- RAW: the develop stage on the card ----------------------------------------

def _raw_develop_both(dev, family, blob):
    """A RAW file's develop stage on the card and on the CPU, and the RGBA
    each gives after the host steps."""
    import chip_smoke
    from paintfe_tpu_torch.io import raw

    develop = chip_smoke._raw_developers()[family]
    got, want = develop(blob, dev), develop(blob, "cpu")
    return got, want, raw._finish_raw(*got), raw._finish_raw(*want)


@pytest.mark.parametrize("shape", [(96, 160), (61, 142)])
@pytest.mark.parametrize("name", ["strips.dng", "deflate.dng", "ljpeg.dng", "lzw.dng",
                                  "canon.cr2", "nikon.nef", "sony.arw", "panasonic.rw2"])
def test_raw_develop_on_the_card_equals_the_cpu(dev, tmp_path, name, shape):
    """Every family of the smoke's RAW phase: _normalize_levels, the gains
    and _demosaic_bilinear on the card give the CPU's linear RGB, and the
    same RGBA."""
    import chip_smoke

    files = chip_smoke.raw_files(tmp_path, *shape)
    (got, got_cm), (want, want_cm), rgba, want_rgba = _raw_develop_both(
        dev, files[name][0], (tmp_path / name).read_bytes())
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (got_cm is None) == (want_cm is None)
    assert np.array_equal(rgba, want_rgba) and rgba.shape[:2] == files[name][1]


@pytest.mark.parametrize("photometric", [1, 32803])
def test_raw_develop_keeps_subnormals_nan_and_inf_on_the_card(dev, photometric):
    """An fp32 DNG with subnormal, NaN and +-inf samples: the card's develop
    stage equals the CPU's (NaN where the CPU has NaN), subnormals are not
    flushed to zero, and the host steps give the same RGBA."""
    import chip_smoke

    h, w = 24, 34
    vals = np.random.default_rng(8).random((h, w), dtype=np.float32)
    vals[0, :6] = [1e-40, -1e-42, np.nan, np.inf, -np.inf, 1.2e-38]
    vals[5, 4:12] = np.float32(2.0 ** -140)
    blob = vals.astype("<f4").tobytes()
    extra = {339: (3, [3]), 262: (3, [photometric])}
    ifds = [(chip_smoke._dng_entries(h, w, (0, 1, 1, 2), extra, [0], bits=32), None)]
    blob = chip_smoke.tiff_bytes(chip_smoke._with_counts(ifds, [blob]), [blob])
    (got, _), (want, _), rgba, want_rgba = _raw_develop_both(dev, "dng", blob)
    assert np.array_equal(got, want, equal_nan=True)
    assert np.isnan(got).any() and np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(rgba, want_rgba)
    if photometric == 1:  # the linear path keeps each sample: no flush to zero
        assert got[0, 0, 0] == np.float32(1e-40) and got[5, 4, 0] == np.float32(2.0 ** -140)


# -- the painting and vector tools on the card ---------------------------------

_TOOL_SHAPE = (53, 67)  # odd sizes: rows, columns


def _tool_selection():
    sel = np.zeros(_TOOL_SHAPE, np.uint8)
    sel[3:50, 9:60] = 255
    sel[20:24, :] = 0
    return sel


def _on_both(dev, make, draw):
    """draw(target) on a u8 tensor on the card and on the CPU, from one
    numpy-seeded image; returns both results on the host."""
    host = make()
    card = torch.from_numpy(host.copy()).to(dev)
    cpu = torch.from_numpy(host.copy())
    draw(card)
    draw(cpu)
    return card.cpu().numpy(), cpu.numpy()


def _tool_image(seed=50):
    return np.random.default_rng(seed).integers(0, 256, _TOOL_SHAPE + (4,), np.uint8)


@pytest.mark.parametrize("mode", ["NORMAL", "DODGE", "BURN", "SPONGE"])
@pytest.mark.parametrize("aa", [True, False], ids=["aa", "aliased"])
@pytest.mark.parametrize("eraser", [False, True], ids=["paint", "erase"])
@pytest.mark.parametrize("props", [{}, {"scatter": 0.5},
                                   {"hue_jitter": 0.7, "brightness_jitter": 0.4}],
                         ids=["plain", "scatter", "jitter"])
def test_brush_on_the_card_equals_the_cpu(dev, mode, aa, eraser, props):
    """A line from beyond the top-left corner off the bottom-right one, under
    a selection; the card's stamps give the CPU's bytes."""
    from paintfe_tpu_torch.tools import Brush, BrushMode

    def draw(img):
        b = Brush(13.0, 0.35, aa, brush_mode=BrushMode[mode])
        for k, v in props.items():
            setattr(b.properties, k, v)
        b.draw_line(img, (-4.0, -3.0), (70.5, 58.25), is_eraser=eraser,
                    primary=(0.8, 0.3, 0.2, 0.9), mask=_tool_selection())
        b.draw_circle(img, (66.0, 0.5), primary=(0.1, 0.9, 0.4, 1.0))

    got, want = _on_both(dev, _tool_image, draw)
    assert np.array_equal(got, want)


def test_brush_stroke_waits_on_nothing(dev):
    """A stroke under a selection queues its stamps without one
    synchronisation of the card (no read-back, no blocking copy)."""
    from paintfe_tpu_torch.tools import Brush, BrushMode
    from paintfe_tpu_torch.tools import clone_heal

    img = torch.from_numpy(_tool_image()).to(dev)
    sel = _tool_selection()
    Brush(9.0).draw_circle(img, (5.0, 5.0))  # the first call's lazy set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Brush(11.0, 0.4).draw_line(img, (2.0, 3.0), (60.0, 50.0), mask=sel)
        Brush(15.0, brush_mode=BrushMode.DODGE).draw_line(img, (60.0, 3.0), (2.0, 50.0),
                                                          mask=sel)
        clone_heal.heal_line(Brush(9.0), img, img.clone(), (5.0, 40.0), (40.0, 45.0), 6.0, sel)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("rotation", [0.0, 30.0, -110.0])
@pytest.mark.parametrize("eraser", [False, True], ids=["paint", "erase"])
def test_image_tip_on_the_card_equals_the_cpu(dev, rotation, eraser):
    from paintfe_tpu_torch.tools import brush_tips

    tip = brush_tips.stock_library().get("Charcoal")
    mask = brush_tips.rebuild_tip_mask(tip, 19.0, 0.7)

    def draw(img):
        for k, pos in enumerate([(30.3, 25.8), (1.0, 50.0), (66.0, 2.5)]):
            brush_tips.draw_image_tip(img, pos, mask, (200, 40, 30, 230), is_eraser=eraser,
                                      flow=0.8, rotation_deg=rotation, scatter=0.4,
                                      stamp_counter=k, brush_size=19, selection=_tool_selection())

    got, want = _on_both(dev, _tool_image, draw)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tool", ["clone", "heal"])
@pytest.mark.parametrize("size,hardness,aa", [(11.0, 0.3, True), (6.0, 1.0, False)])
def test_clone_heal_on_the_card_equals_the_cpu(dev, tool, size, hardness, aa):
    from paintfe_tpu_torch.tools import Brush, clone_heal

    src = _tool_image(51)

    def draw(img):
        b = Brush(size, hardness, aa)
        source = torch.from_numpy(src).to(img.device)
        if tool == "clone":
            clone_heal.clone_stamp_line(b, img, source, (-0.5, 3.0), (66.0, 52.0), (-7.5, 3.5),
                                        _tool_selection())
        else:
            clone_heal.heal_line(b, img, source, (-0.5, 3.0), (66.0, 52.0), 7.0,
                                 _tool_selection())

    got, want = _on_both(dev, lambda: np.zeros(_TOOL_SHAPE + (4,), np.uint8), draw)
    assert np.array_equal(got, want) and (got[..., 3] > 0).any()


@pytest.mark.parametrize("pattern,cap,arrow", [("solid", "round", "none"),
                                               ("dashed", "flat", "both"),
                                               ("dotted", "round", "start")])
def test_bezier_on_the_card_equals_the_cpu(dev, pattern, cap, arrow):
    from paintfe_tpu_torch.tools import vector_tools

    cps = [(2.5, 50.2), (20.0, -10.0), (60.0, 80.0), (66.3, 5.1)]

    def draw(img):
        vector_tools.rasterize_bezier(img, cps, (200, 30, 40, 220), 4.0, pattern=pattern,
                                      cap_style=cap, selection=_tool_selection(),
                                      arrow_side=arrow)

    got, want = _on_both(dev, _tool_image, draw)
    assert np.array_equal(got, want)


_SHAPE_KINDS = ["ELLIPSE", "ROUNDED_RECT", "TRIANGLE", "PARALLELOGRAM", "PENTAGON",
                "OCTAGON", "CROSS", "CHECK", "HEART", "DIAMOND", "STAR5", "STAR6", "ARROW"]


@pytest.mark.parametrize("kind", _SHAPE_KINDS)
@pytest.mark.parametrize("fill", ["FILLED", "OUTLINE", "BOTH"])
def test_shape_on_the_card_equals_the_cpu(dev, kind, fill):
    """Each shape over the canvas's right edge, rotated, on the card and on
    the CPU (the polygon and star SDFs' angles from the host)."""
    from paintfe_tpu_torch.ops import shapes

    placed = shapes.PlacedShape(55.3, 20.7, 21.2, 15.9, 0.45, shapes.ShapeKind[kind],
                                shapes.ShapeFillMode[fill], 3.5, (200, 60, 30, 230),
                                (20, 90, 250, 255), True, 5.0)
    got = shapes.rasterize_to_canvas(placed, 67, 53, device=dev).cpu().numpy()
    assert np.array_equal(got, shapes.rasterize_to_canvas(placed, 67, 53, device="cpu").numpy())


@pytest.mark.parametrize("fill", ["FILLED", "OUTLINE", "BOTH"])
def test_custom_shape_on_the_card_equals_the_cpu(dev, fill):
    import chip_smoke
    from paintfe_tpu_torch.ops import shapes

    data = shapes.parse_custom_shape("c", "t", shapes.extract_svg_path_data(chip_smoke.TOOL_SVG))
    placed = shapes.PlacedShape(30.0, 26.0, 25.0, 22.0, 0.3, shapes.ShapeKind.RECTANGLE,
                                shapes.ShapeFillMode[fill], 2.0, custom_shape_data=data)
    got = shapes.rasterize_to_canvas(placed, 67, 53, device=dev).cpu().numpy()
    assert np.array_equal(got, shapes.rasterize_to_canvas(placed, 67, 53, device="cpu").numpy())
    icon = shapes.render_custom_shape_icon(data, 37, True, device=dev).cpu().numpy()
    assert np.array_equal(icon, shapes.render_custom_shape_icon(data, 37, True, "cpu").numpy())


def test_perspective_crop_on_the_card_equals_the_cpu(dev):
    import chip_smoke
    from paintfe_tpu_torch.tools import vector_tools

    doc = chip_smoke.tools_document(np.random.default_rng(3), 53, 67)
    doc.layers[1].mask = np.random.default_rng(4).integers(0, 256, (53, 67), np.uint8)
    card, host = doc, copy.deepcopy(doc)
    corners = [(3.5, 2.2), (66.1, 6.7), (60.4, 52.0), (-2.2, 45.3)]
    assert vector_tools.apply_perspective_crop(card, corners, device=dev)
    assert vector_tools.apply_perspective_crop(host, corners, device="cpu")
    assert chip_smoke.document_differences(card, host) == []


@pytest.mark.parametrize("fmt", ["RgbaU8", "RgbaU16", "RgbaF16", "RgbaF32"])
def test_sync_region_from_a_card_tensor_equals_the_cpu(dev, fmt):
    from paintfe_tpu_torch.core.deep import DeepRgbaBuffer, PixelFormat

    base, preview = _tool_image(60), _tool_image(61)
    card = DeepRgbaBuffer.from_rgba8(base, PixelFormat(fmt))
    host = DeepRgbaBuffer.from_rgba8(base, PixelFormat(fmt))
    card.sync_region_from_u8(torch.from_numpy(preview).to(dev), -3, 5, 40, 70)
    host.sync_region_from_u8(preview, -3, 5, 40, 70)
    assert np.array_equal(card.data.view(np.uint8), host.data.view(np.uint8))


def test_tools_path_on_the_card_equals_the_cpu(dev, tmp_path):
    """chip_smoke's tools path at 128x96: every step on the card against the
    same step on the CPU (document, deep buffer, history, the displayed
    composite); K-composite launches once a raster run of each display and
    once for the merge down, no other kernel; undo to the start and redo
    to the end."""
    import chip_smoke
    from paintfe_tpu_torch.core.history import HistoryManager
    from paintfe_tpu_torch.core.project import Project
    from paintfe_tpu_torch.io.pfe import save_pfe

    src = tmp_path / "doc.pfe"
    save_pfe(chip_smoke.tools_document(np.random.default_rng(13), 96, 128), str(src))
    card, host = Project.open(src, device=dev), Project.open(src, device="cpu")
    for p in (card, host):
        p.history = HistoryManager(max_entries=100, memory_limit_bytes=1 << 30)
    states, caches = ({}, {}), ({}, {})
    counts = {name: fn.launches for name, fn in chip_smoke._wrappers().items()}
    for (name, step), (_, cpu_step) in zip(
            chip_smoke.tool_steps(chip_smoke.tool_modules(dev), {"device": dev}),
            chip_smoke.tool_steps(chip_smoke.tool_modules("cpu"), {"device": "cpu"})):
        got = chip_smoke._tools_parts(card, states[0], step(card, states[0]), caches[0])
        want = chip_smoke._tools_parts(host, states[1], cpu_step(host, states[1]), caches[1])
        assert got == want, (name, sorted(k for k in got if got[k] != want.get(k)))
    torch.cuda.synchronize()
    launched = {name: fn.launches - counts[name] for name, fn in chip_smoke._wrappers().items()}
    want = {name: 0 for name in launched}
    want["composite_stack_kernel"] = states[0]["composites"] + 1
    assert launched == want
    while card.history.undo(card.canvas):
        pass
    assert chip_smoke.document_differences(card.canvas, Project.open(src, "cpu").canvas) == []
    while card.history.redo(card.canvas):
        pass
    assert chip_smoke.document_differences(card.canvas, host.canvas) == []


# --- the server path and the services (PR 13) -----------------------------------


def _server_files(root):
    """A 64x48 noise PNG, a three-layer .pfe and the smoke's scripts."""
    import chip_smoke
    from paintfe_tpu_torch.io.pfe import save_pfe

    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (48, 64, 4), np.uint8)
    img[:6, :, 3] = 0
    from PIL import Image

    Image.fromarray(img, "RGBA").save(root / "in.png")
    save_pfe(chip_smoke._layered_document(rng, 96, 128), str(root / "doc.pfe"))
    jobs = {}
    for kind, (inp, script, fmt) in {
            "headline": ("in.png", chip_smoke.HEADLINE, "png"),
            "spatial": ("in.png", chip_smoke.SPATIAL, "png"),
            "effects": ("in.png", chip_smoke.EFFECTS, "png"),
            "layered png": ("doc.pfe", chip_smoke.LAYERED, "png"),
            "layered pfe": ("doc.pfe", chip_smoke.LAYERED, "pfe")}.items():
        name = kind.replace(" ", "_")
        (root / f"{name}.rhai").write_text(script)
        jobs[kind] = {"input": str(root / inp), "script": str(root / f"{name}.rhai"),
                      "format": fmt, "output": f"{name}.{fmt}"}
    return jobs


def test_server_on_the_card_equals_the_cpu_with_two_clients(dev, tmp_path):
    """The jobs through a server on the card give the bytes of a server on
    the CPU; two clients at once on the card give the same bytes again."""
    import threading

    import chip_smoke
    from paintfe_tpu_torch import server as srv

    jobs = _server_files(tmp_path)

    def job(kind, d):
        return dict(jobs[kind], output=str(tmp_path / d / jobs[kind]["output"]))

    servers = {}
    try:
        for d in ("cuda", "cpu"):
            s, port = srv.serve_tcp(port=0, device=dev if d == "cuda" else "cpu")
            threading.Thread(target=s.serve_forever, daemon=True).start()
            servers[d] = (s, port)
            for kind in jobs:
                assert srv.request(port, job(kind, d))["ok"], (d, kind)
        out = [None, None]

        def client(c):
            out[c] = chip_smoke._client(servers["cuda"][1],
                                        [job(k, f"c{c}_{r}") for r in range(2) for k in jobs])

        threads = [threading.Thread(target=client, args=(c,)) for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        assert all(r["ok"] for replies in out for r, _ in replies)
        assert srv.request(servers["cuda"][1], {"cmd": "ping"})["jobs_done"] == 5 * len(jobs)
    finally:
        for s, _ in servers.values():
            s.shutdown()
            s.server_close()
    for kind, spec in jobs.items():
        want = (tmp_path / "cpu" / spec["output"]).read_bytes()
        for d in ["cuda"] + [f"c{c}_{r}" for c in range(2) for r in range(2)]:
            assert (tmp_path / d / spec["output"]).read_bytes() == want, (kind, d)


def test_plugin_render_of_a_card_tensor(dev, tmp_path):
    import sys

    import chip_smoke
    from paintfe_tpu_torch.ops.plugins import PluginHost

    exe = tmp_path / "invert.py"
    exe.write_text(chip_smoke.NUMPY_PLUGIN)
    img = _img((53, 67), 31, "cpu")
    host = PluginHost(exe, launcher=(sys.executable,))
    try:
        on_card = host.render("invert", img.to(dev))
        on_cpu = host.render("invert", img)
    finally:
        host.close()
    assert on_card.device == img.to(dev).device and on_card.dtype == torch.uint8
    assert torch.equal(on_card.cpu(), on_cpu)
    assert torch.equal(on_card, chip_smoke.inverted(img.to(dev)))


@pytest.mark.parametrize("kind", ["u2net", "birefnet"])
@pytest.mark.parametrize("probabilities", [False, True])
@pytest.mark.parametrize("threshold", [None, 0.5])
def test_remove_background_on_the_card_equals_the_cpu(dev, kind, probabilities, threshold):
    import chip_smoke
    from paintfe_tpu_torch.ops import ai

    img = _img((75, 101), 32, "cpu")
    img[:10, :, 3] = 128
    removers = [ai.BackgroundRemover(model_kind=kind, session=chip_smoke.SmokeSession(probabilities),
                                     device=d) for d in (dev, "cpu")]
    got = removers[0].remove_background(img.to(dev), threshold)
    assert got.device == img.to(dev).device
    assert torch.equal(got.cpu(), removers[1].remove_background(img, threshold))
    x = removers[0].preprocess(img.to(dev))
    assert x.is_cuda and torch.equal(x.cpu(), removers[1].preprocess(img))


def test_stage_timer_on_the_card_waits_for_queued_work(dev):
    from paintfe_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()  # the card by default
    assert timer.device.type == "cuda"
    with timer.stage("sleep"):
        torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock
        done = torch.cuda.Event()
        done.record()
    assert done.query()  # the stage ended after the queued work
    assert timer.totals()["sleep"] > 0.01


def test_double_buffer_with_card_produce_waits_on_nothing(dev):
    """Items made on the card on the staging thread reach the consumer's
    stream by an event: no host synchronisation anywhere in the loop."""
    from paintfe_tpu_torch.parallel.prefetch import DoubleBuffer

    base = _img((270, 480), 33, dev)

    def produce(i):
        torch.cuda._sleep(2_000_000)
        return kernels.gaussian_blur_fused(base, 1.0 + i), base.roll(i, 0)

    acc = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for blurred, rolled in DoubleBuffer(produce, 6):
            acc.append(torch.cat([blurred, rolled]).int().sum(dim=(0, 1)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [torch.cat([kernels.gaussian_blur_plain(base, 1.0 + i), base.roll(i, 0)])
            .int().sum(dim=(0, 1)) for i in range(6)]
    assert all(torch.equal(a, w) for a, w in zip(acc, want)) and len(acc) == 6


# -- the multi-GPU layer: spatial sharding on repeated card entries -----------


def _spatial_case(dev, n, h, w):
    """The spatial calls on an n-entry rows mesh of `dev` against the same
    kernel on one device: (name, kernel wrapper, sharded, single, halo)."""
    from paintfe_tpu_torch.core.composite import composite_stack_static
    from paintfe_tpu_torch.parallel import spatial

    img, ov = _img((h, w), 41, dev), _img((h, w), 42, dev)
    stack = _img((5, h, w), 43, dev)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    sx = (xx + 3.0 * torch.sin(yy / 9.0) - 1.5).contiguous()
    sy = (yy + 2.0 * torch.cos(xx / 7.0) + 0.75).contiguous()
    mesh = spatial.rows_mesh([dev] * n)
    modes, opac = (0, 8, 16, 3, 21), (1.0, 0.8, 0.5, 0.9, 0.7)
    return mesh, [
        ("chain", fused_chain_kernel, lambda: spatial.fused_chain_spatial(img, ov, mesh),
         lambda: fused_chain_kernel(img, ov), 6),
        ("median", kernels.median_kernel, lambda: spatial.median_spatial(img, 2, mesh),
         lambda: kernels.median_kernel(img, 2), 2),
        ("warp zero", warp_kernel.gather_bilinear_u8,
         lambda: spatial.warp_spatial(img, sx, sy, "zero", mesh),
         lambda: warp_kernel.gather_bilinear_u8(img, sx, sy, "zero"), 0),
        ("warp clamp", warp_kernel.gather_bilinear_u8,
         lambda: spatial.warp_spatial(img, sx, sy, "clamp", mesh),
         lambda: warp_kernel.gather_bilinear_u8(img, sx, sy, "clamp"), 0),
        ("composite", kernels.composite_stack_kernel,
         lambda: spatial.composite_spatial(stack, modes, opac, mesh),
         lambda: composite_stack_static(stack, modes, opac), 0),
        ("blur", kernels.gaussian_blur_fused,
         lambda: spatial.process_spatial(img, lambda x: kernels.gaussian_blur_fused(x, 3.0),
                                         mesh, halo=9),
         lambda: kernels.gaussian_blur_fused(img, 3.0), 9),
    ]


@pytest.mark.parametrize("n,h", [(2, 96), (3, 61), (8, 130)])
def test_spatial_on_repeated_card_entries_equals_one_device(dev, n, h):
    """Each spatial function on n entries of one card (ragged heights
    included): one launch an entry, equal to the single-device kernel."""
    from paintfe_tpu_torch.parallel import spatial

    _, cases = _spatial_case(dev, n, h, 84)
    for name, wrapper, sharded, single, r in cases:
        want = single()
        before = wrapper.launches
        got = sharded()
        torch.cuda.synchronize()
        assert spatial.route(h, n, r) == "sharded", name
        assert wrapper.launches == before + n, name
        assert got.device == dev and torch.equal(got, want), name


def test_spatial_single_device_route_and_grid_on_the_card(dev):
    """Blocks shorter than the halo: one launch on the first entry; the
    2x4 grid: each image once a rows entry; both equal to one device."""
    from paintfe_tpu_torch.parallel import spatial

    img, ov = _img((20, 64), 44, dev), _img((20, 64), 45, dev)
    before = fused_chain_kernel.launches
    out = spatial.fused_chain_spatial(img, ov, spatial.rows_mesh([dev] * 8))
    assert fused_chain_kernel.launches == before + 1
    assert torch.equal(out, fused_chain_kernel(img, ov))
    imgs, ovs = _img((4, 61, 72), 46, dev), _img((4, 61, 72), 47, dev)
    grid = spatial.grid_mesh(2, 4, [dev] * 8)
    before = fused_chain_kernel.launches
    out = spatial.fused_chain_grid(imgs, ovs, grid)
    torch.cuda.synchronize()
    assert fused_chain_kernel.launches == before + 16
    assert torch.equal(out, torch.stack([fused_chain_kernel(imgs[i], ovs[i]) for i in range(4)]))


@pytest.mark.parametrize("h", [61, 96])
def test_spatial_one_entry_runs_the_kernel_where_the_image_lies(dev, h):
    """fused_chain_spatial and composite_spatial on rows_mesh([card]): one
    launch, no byte copied by the spatial layer, byte-equal to the
    single-device kernel; the grid on grid_mesh(4, 1) keeps its batch
    split, one launch an image."""
    from paintfe_tpu_torch.core.composite import composite_stack_static
    from paintfe_tpu_torch.parallel import spatial
    from paintfe_tpu_torch.utils import profiling

    img, ov, stack = _img((h, 84), 50, dev), _img((h, 84), 51, dev), _img((5, h, 84), 52, dev)
    modes, opac = (0, 8, 16, 3, 21), (1.0, 0.8, 0.5, 0.9, 0.7)
    mesh = spatial.rows_mesh([dev])
    for wrapper, call, single in (
            (fused_chain_kernel, lambda: spatial.fused_chain_spatial(img, ov, mesh),
             lambda: fused_chain_kernel(img, ov)),
            (kernels.composite_stack_kernel,
             lambda: spatial.composite_spatial(stack, modes, opac, mesh),
             lambda: composite_stack_static(stack, modes, opac))):
        want = single()
        before, copied = wrapper.launches, profiling.counts()
        got = call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert {n: c for n, c in profiling.counts().items()
                if n.startswith("spatial.copy_bytes.") and c != copied.get(n, 0)} == {}
        assert got.device == dev and torch.equal(got, want)
    imgs, ovs = _img((4, h, 72), 53, dev), _img((4, h, 72), 54, dev)
    before = fused_chain_kernel.launches
    out = spatial.fused_chain_grid(imgs, ovs, spatial.grid_mesh(4, 1, [dev] * 4))
    torch.cuda.synchronize()
    assert fused_chain_kernel.launches == before + 4
    assert torch.equal(out, torch.stack([fused_chain_kernel(imgs[i], ovs[i]) for i in range(4)]))


def test_run_batch_over_repeated_card_entries_equals_the_cpu(dev):
    """run_batch on a 3-entry mesh of the card: one K-blur launch an entry,
    equal to the CPU run."""
    from paintfe_tpu_torch.parallel.mesh import Mesh

    ops = pipeline.trace_script("apply_blur(2.0); apply_sepia(0.5);")
    images = np.random.default_rng(48).integers(0, 256, (4, 40, 56, 4), np.uint8)
    before = kernels.gaussian_blur_fused.launches
    got = pipeline.run_batch(images, ops, Mesh([dev] * 3, ("batch",)))
    assert kernels.gaussian_blur_fused.launches == before + 3
    assert np.array_equal(got, pipeline.run_batch(images, ops, "cpu"))


_PAIR_WORKER = """
import sys, torch
from paintfe_tpu_torch.core.composite import composite_stack_static
from paintfe_tpu_torch.ops import kernels, warp_kernel
from paintfe_tpu_torch.ops.fused_chain import fused_chain_kernel
from paintfe_tpu_torch.parallel import distributed, spatial

assert distributed.maybe_initialize()
me, dev = distributed.rank(), torch.device("cuda", 0)
g = distributed.global_batch_mesh([dev] * 4)
rows = spatial.rows_mesh(g)
gen = torch.Generator(device=dev).manual_seed(49)

def img(*shape):
    return torch.randint(0, 256, shape + (4,), generator=gen, dtype=torch.uint8, device=dev)

a, b, stack, frames = img(61, 84), img(61, 84), img(5, 61, 84), img(4, 64, 72)
yy, xx = torch.meshgrid(torch.arange(61, dtype=torch.float32, device=dev),
                        torch.arange(84, dtype=torch.float32, device=dev), indexing="ij")
sx = (xx + 3.0 * torch.sin(yy / 9.0) - 1.5).contiguous()
sy = (yy + 2.0 * torch.cos(xx / 7.0) + 0.75).contiguous()
modes, opac = (0, 8, 16, 3, 21), (1.0, 0.8, 0.5, 0.9, 0.7)
one = lambda fn: lambda: torch.stack([fn(frames[i], frames[3 - i]) for i in range(4)])
cases = [  # wrapper, cross-process call, single-device call, launches in each process
    (fused_chain_kernel, lambda: spatial.fused_chain_spatial(a, b, rows),
     lambda: fused_chain_kernel(a, b), (4, 4)),
    (fused_chain_kernel, lambda: spatial.fused_chain_spatial(a[:20], b[:20], rows),
     lambda: fused_chain_kernel(a[:20], b[:20]), (1, 0)),
    (kernels.median_kernel, lambda: spatial.median_spatial(a, 2, rows),
     lambda: kernels.median_kernel(a, 2), (4, 4)),
    (warp_kernel.gather_bilinear_u8, lambda: spatial.warp_spatial(a, sx, sy, "clamp", rows),
     lambda: warp_kernel.gather_bilinear_u8(a, sx, sy, "clamp"), (4, 4)),
    (kernels.composite_stack_kernel, lambda: spatial.composite_spatial(stack, modes, opac, rows),
     lambda: composite_stack_static(stack, modes, opac), (4, 4)),
    (kernels.gaussian_blur_fused,
     lambda: spatial.process_spatial(a, lambda x: kernels.gaussian_blur_fused(x, 1.5), rows,
                                     halo=5), lambda: kernels.gaussian_blur_fused(a, 1.5), (4, 4)),
    (fused_chain_kernel,
     lambda: spatial.fused_chain_grid(frames, frames.flip(0), spatial.grid_mesh(2, 4, g)),
     one(fused_chain_kernel), (8, 8)),
    (fused_chain_kernel,
     lambda: spatial.fused_chain_grid(frames, frames.flip(0), spatial.grid_mesh(1, 8, g)),
     one(fused_chain_kernel), (16, 16)),
]
for k, (wrapper, cross, single, launches) in enumerate(cases):
    before = wrapper.launches
    out = cross()
    torch.cuda.synchronize()
    assert wrapper.launches - before == launches[me], (k, wrapper.launches - before)
    assert (torch.equal(out, single()) and out.device == dev) if me == 0 else out is None, k
assert "jax" not in sys.modules and "paintfe_tpu" not in sys.modules
print("PAIR-OK", me)
"""


def test_spatial_across_two_processes_on_the_card(dev, tmp_path):
    """Every spatial call on an 8-entry rows mesh split 4 + 4 over two gloo
    processes sharing the card (and fused_chain_grid on both 2-D layouts):
    process 0's result equals the single-device kernel, process 1 returns
    None, each process launches once an owned entry (the single-device
    route: once, in process 0)."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = pathlib.Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PAIR_WORKER], cwd=tmp_path, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, PAINTFE_COORDINATOR=f"localhost:{port}", PAINTFE_NUM_PROCESSES="2",
                 PAINTFE_PROCESS_ID=str(k),
                 PYTHONPATH=os.pathsep.join(filter(None, [str(repo),
                                                          os.environ.get("PYTHONPATH")]))))
        for k in (0, 1)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for k, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"PAIR-OK {k}" in out, out[-3000:]


# -- the JAX suite's cases that reach a kernel (test_torch_script_api,
# test_torch_experimental, test_torch_review_r5_parity, test_torch_cli_io),
# on the card against the CPU route


@pytest.mark.parametrize("source", ["apply_blur(2.0);",
                                    "apply_blur(1.0);\napply_invert();\nset_pixel(0, 0, 1, 2, 3, 4);"])
def test_script_api_blur_on_the_card_equals_the_cpu(dev, source):
    from paintfe_tpu_torch.core import fixtures
    from paintfe_tpu_torch.scripting import execute_script_sync

    img = fixtures.test_gradient(64, 64)
    before = kernels.gaussian_blur_fused.launches
    card = execute_script_sync(source, img.copy(), 64, 64, None, device=dev)
    assert kernels.gaussian_blur_fused.launches == before + 1
    host = execute_script_sync(source, img.copy(), 64, 64, None, device="cpu")
    assert np.array_equal(card[0], host[0]) and card[1:4] == host[1:4]


def _adjusted_doc(fill, kind, opacity, **params):
    from paintfe_tpu_torch.core import fixtures
    from paintfe_tpu_torch.core.canvas import Canvas, Layer
    from paintfe_tpu_torch.core.deep import AdjustmentKind, AdjustmentLayerData

    c = Canvas.from_image(fixtures.solid(4, 4, fill))
    adj = Layer.new(kind.lower(), 4, 4)
    adj.content = "adjustment"
    adj.adjustment = AdjustmentLayerData(kind=AdjustmentKind[kind], **params)
    adj.opacity = opacity
    c.layers.append(adj)
    return c


@pytest.mark.parametrize("fill,kind,opacity,params", [
    ((10, 20, 30, 255), "INVERT", 1.0, {}),
    ((128, 128, 128, 255), "INVERT", 0.5, {}),
    ((50, 100, 200, 255), "EXPOSURE", 1.0, {"ev": 1.0}),
    ((60, 90, 120, 255), "BRIGHTNESS_CONTRAST", 1.0, {"brightness": 10.0, "contrast": 5.0}),
], ids=["invert", "invert_half_opacity", "exposure", "brightness_contrast"])
def test_adjustment_layer_composite_on_the_card_equals_the_cpu(dev, fill, kind, opacity, params):
    from paintfe_tpu_torch.io import deep_export

    c = _adjusted_doc(fill, kind, opacity, **params)
    before = kernels.composite_stack_kernel.launches
    card = c.composite(device=dev)
    assert kernels.composite_stack_kernel.launches == before + 1
    assert np.array_equal(card, c.composite(device="cpu"))
    a = deep_export.prepare_export_image(c, device=dev)
    b = deep_export.prepare_export_image(c, device="cpu")
    assert (a.kind, a.width, a.height) == (b.kind, b.width, b.height)
    assert np.array_equal(a.data, b.data)


def test_merge_down_of_a_text_layer_on_the_card_equals_the_cpu(dev):
    from paintfe_tpu_torch.core.canvas import Canvas, Layer
    from paintfe_tpu_torch.ops.canvas_ops import merge_down
    from paintfe_tpu_torch.ops.text_layer import make_text_layer_data

    docs = []
    for device in (dev, "cpu"):
        c = Canvas.new(64, 32, (255, 255, 255, 255))
        top = Layer.new("text", 64, 32, (0, 0, 0, 0))
        top.content = "text"
        top.text_data = make_text_layer_data("Hi", 4, 4, size=16, color=(255, 0, 0, 255))
        c.layers.append(top)
        before = kernels.composite_stack_kernel.launches
        merge_down(c, 1, device=device)
        if device is dev:
            assert kernels.composite_stack_kernel.launches == before + 1
        docs.append(c)
    assert len(docs[0].layers) == 1 and docs[0].layers[0].content == "raster"
    assert np.array_equal(docs[0].layers[0].pixels, docs[1].layers[0].pixels)


def test_device_cache_mask_bake_on_the_card_equals_the_cpu(dev):
    from paintfe_tpu_torch.core.canvas import Canvas
    from paintfe_tpu_torch.core.device import DeviceLayerCache, composite_device
    from paintfe_tpu_torch.ops.canvas_ops import apply_layer_mask

    out = []
    for device in (dev, "cpu"):
        c = Canvas.new(8, 8, (100, 100, 100, 255))
        c.layers[0].mask = np.full((8, 8), 255, np.uint8)
        cache = DeviceLayerCache(device=device)
        before = composite_device(c, cache).cpu().numpy()
        apply_layer_mask(c, 0)
        launches = kernels.composite_stack_kernel.launches
        after = composite_device(c, cache)
        assert after.device.type == torch.device(device).type
        if device is dev:
            assert kernels.composite_stack_kernel.launches == launches + 1
        out.append((before, cache.get(c.layers[0]).cpu().numpy(), after.cpu().numpy()))
    for a, b in zip(*out):
        assert np.array_equal(a, b)
    assert out[0][1][..., 3].max() == 0, "cache served the stale upload"


def test_cli_flatten_of_pdn_and_pfe_on_the_card_equals_the_cpu(dev, tmp_path):
    """A .pdn in the reference fixture's layout (800x600, red Normal under
    green Additive at 161) and a two-layer .pfe through the CLI: one
    K-composite launch each, the same PNG bytes as the CPU route."""
    import chip_smoke
    from paintfe_tpu_torch import cli
    from paintfe_tpu_torch.core import fixtures
    from paintfe_tpu_torch.core.canvas import Canvas, Layer
    from paintfe_tpu_torch.io.pfe import save_pfe

    layers = []
    for name, rgb, opacity, blend in (("Background", (255, 0, 0), 255, "Normal"),
                                      ("Layer 2", (0, 255, 0), 161, "Additive")):
        px = np.zeros((600, 800, 4), np.uint8)
        px[...] = rgb + (255,)
        layers.append(dict(name=name, pixels=px, visible=True, opacity=opacity, blend=blend))
    (tmp_path / "doc.pdn").write_bytes(chip_smoke.pdn_bytes(layers, 800, 600))
    c = Canvas.from_image(fixtures.test_checkerboard(70, 50))
    top = Layer(name="top", pixels=fixtures.blend_test_foreground(70, 50))
    top.blend_mode, top.opacity = BlendMode.MULTIPLY, 0.7
    c.layers.append(top)
    save_pfe(c, str(tmp_path / "doc.pfe"))
    for src in ("doc.pdn", "doc.pfe"):
        before = kernels.composite_stack_kernel.launches
        assert cli.main(["-i", str(tmp_path / src), "-o", str(tmp_path / "card.png"),
                         "-f", "png", "--device", "cuda"]) == 0
        assert kernels.composite_stack_kernel.launches == before + 1
        assert cli.main(["-i", str(tmp_path / src), "-o", str(tmp_path / "host.png"),
                         "-f", "png", "--device", "cpu"]) == 0
        assert (tmp_path / "card.png").read_bytes() == (tmp_path / "host.png").read_bytes(), src
