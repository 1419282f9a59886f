"""The port's document model (paintfe_tpu_torch.core.{canvas,deep,device})
against the JAX package's: Canvas.composite with masks, a hidden folder,
adjustment layers of every kind, the preview overlay and the active-tile
mask; composite_device and composite_dirty_rect; canvas_from_document on
a JAX Canvas.  The same seeded inputs, device "cpu", tolerance 0."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paintfe_tpu.core import canvas as jcanvas
from paintfe_tpu.core import deep as jdeep
from paintfe_tpu.core import device as jdevice
from paintfe_tpu.core.blend import BlendMode as JMode
from paintfe_tpu_torch.core import canvas as tcanvas
from paintfe_tpu_torch.core import deep as tdeep
from paintfe_tpu_torch.core import device as tdevice

H, W = 130, 150  # 3 x 3 tiles of 64 px, the last ones ragged

ADJUSTMENTS = [
    dict(kind=0, ev=0.7),
    dict(kind=0, ev=-1.3),
    dict(kind=1, brightness=12.0, contrast=30.0),
    dict(kind=1, brightness=-40.0, contrast=-80.0),
    dict(kind=2),
    dict(kind=3, red=(0.5, 0.3, 0.2, 0.0), green=(0.1, 1.2, 0.0, 0.1),
         blue=(0.0, 0.0, 0.9, 0.3), alpha=(0.0, 0.0, 0.0, 1.0)),
]


def _rand(rng, shape):
    return rng.integers(0, 256, shape, np.uint8)


def _document(seed, adjustment=None, preview=None):
    """A JAX Canvas: masked layers, a hidden folder, an adjustment layer
    mid-stack, tile (64..128, 64..128) empty in every raster layer and tile
    (0..64, 128..150) empty in all but the hidden one."""
    rng = np.random.default_rng(seed)
    c = jcanvas.Canvas.new(W, H)
    c.layers = []
    c.folders = [jcanvas.LayerFolder(id=3, name="hidden", visible=False),
                 jcanvas.LayerFolder(id=4, name="shown")]
    specs = [("base", JMode.NORMAL, 1.0, None), ("mul", JMode.MULTIPLY, 0.7, None),
             ("soft", JMode.SOFT_LIGHT, 1.0, 4), ("adj", None, 0.6, None),
             ("screen", JMode.SCREEN, 0.9, None), ("ghost", JMode.DIFFERENCE, 1.0, 3)]
    for name, mode, opacity, folder in specs:
        layer = jcanvas.Layer.new(name, W, H)
        layer.opacity = opacity
        layer.folder_id = folder
        if mode is None:
            layer.content = "adjustment"
            layer.adjustment = jdeep.AdjustmentLayerData(**(adjustment or dict(kind=2)))
        else:
            layer.blend_mode = mode
            px = _rand(rng, (H, W, 4))
            px[64:128, 64:128] = 0
            if name != "ghost":
                px[0:64, 128:] = 0
            px[5:9, :, 3] = 255
            layer.pixels = px
        c.layers.append(layer)
    c.layers[1].mask = _rand(rng, (H, W))
    c.layers[4].mask = _rand(rng, (H, W))
    c.layers[4].mask_enabled = False  # a disabled mask changes nothing
    c.active_layer_index = 4
    if preview is not None:
        pv = np.zeros((H, W, 4), np.uint8)
        pv[10:60, 20:90] = _rand(rng, (50, 70, 4))
        c.preview = pv
        c.preview_blend_mode = JMode(preview[0])
        c.preview_is_eraser = preview[1] == "eraser"
        c.preview_replaces_layer = preview[1] == "replace"
    return c


@pytest.mark.parametrize("adj", range(len(ADJUSTMENTS)))
def test_canvas_composite_matches_jax(adj):
    jdoc = _document(adj, ADJUSTMENTS[adj])
    doc = tcanvas.canvas_from_document(jdoc)
    out = doc.composite(device="cpu")
    ref = jdoc.composite()
    np.testing.assert_array_equal(out, ref)
    assert (out[64:128, 64:128] == 0).all()  # the active-tile mask ran


@pytest.mark.parametrize("preview", [(0, "blend"), (1, "blend"), (13, "blend"),
                                     (14, "blend"), (0, "eraser"), (0, "replace")])
def test_preview_overlay_matches_jax(preview):
    jdoc = _document(20, ADJUSTMENTS[4], preview)
    out = tcanvas.canvas_from_document(jdoc).composite(device="cpu")
    np.testing.assert_array_equal(out, jdoc.composite())


def test_visibility_rules_match_jax():
    jdoc = _document(21)
    jdoc.folders[0].visible = True  # the ghost layer shows
    jdoc.layers[0].visible = False
    np.testing.assert_array_equal(
        tcanvas.canvas_from_document(jdoc).composite(device="cpu"), jdoc.composite())
    for layer in jdoc.layers:
        layer.visible = False
    np.testing.assert_array_equal(
        tcanvas.canvas_from_document(jdoc).composite(device="cpu"), jdoc.composite())


@pytest.mark.parametrize("rect", [None, (0, 0, H, W), (60, 70, 40, 50), (127, 0, 3, W)])
def test_active_tile_mask_matches_jax(rect):
    jdoc = _document(22)
    doc = tcanvas.canvas_from_document(jdoc)
    got = doc.active_tile_mask(doc.visible_layers(), rect)
    want = jdoc.active_tile_mask([(i, l) for i, l in enumerate(jdoc.layers)
                                  if jdoc.layer_effectively_visible(i)], rect)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def _device_mask(doc, rect):
    """active_tile_mask_device on the CPU, fed as the flatten feeds it: the
    raw alpha planes of the visible raster layers and of the preview, cut to
    the rect grown to the tile grid."""
    ty0, tx0, rh, rw = tcanvas.tile_window(doc.height, doc.width, rect)
    planes = [l.pixels for _, l in doc.visible_layers() if l.content != "adjustment"]
    if doc.preview is not None:
        planes.append(doc.preview)
    alphas = [torch.from_numpy(p)[ty0:ty0 + rh, tx0:tx0 + rw, 3] for p in planes]
    return tcanvas.active_tile_mask_device(alphas, doc.height, doc.width, rect)


RECTS = [None, (0, 0, H, W), (60, 70, 40, 50), (127, 0, 3, W), (70, 5, 20, 30),
         (0, 128, 64, 22), (64, 64, 64, 64)]


@pytest.mark.parametrize("preview", [None, (0, "blend"), (0, "eraser"), (0, "replace")])
@pytest.mark.parametrize("rect", RECTS)
def test_device_tile_mask_equals_the_host_mask_and_jax(rect, preview):
    """The preview covers part of the tile that is empty in every layer;
    with a replacing preview the active layer's own alpha still counts (the
    mask reads the raw layers)."""
    jdoc = _document(40, ADJUSTMENTS[2], preview)
    if preview is not None:
        jdoc.preview[70:90, 100:120] = 200
    for k, layer in enumerate(jdoc.layers):  # a tile only the active layer fills
        layer.pixels[0:64, 128:] = 180 if k == 4 else 0
    doc = tcanvas.canvas_from_document(jdoc)
    got = _device_mask(doc, rect)
    bh, bw = (H, W) if rect is None else rect[2:]
    assert got.dtype == torch.bool and tuple(got.shape) == (bh, bw)
    host = doc.active_tile_mask(doc.visible_layers(), rect)
    want = jdoc.active_tile_mask([(i, l) for i, l in enumerate(jdoc.layers)
                                  if jdoc.layer_effectively_visible(i)], rect)
    assert (host is None) == (want is None)
    if want is None:  # every tile of the window holds data
        assert bool(got.all())
    else:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("rect", [None, (3, 5, 100, 120)])
def test_device_tile_mask_is_all_true_where_the_host_mask_is_none(rect):
    jdoc = _document(41)
    jdoc.layers[0].pixels = jdoc.layers[0].pixels.copy()
    jdoc.layers[0].pixels[..., 3] = 9  # the base layer fills every tile
    doc = tcanvas.canvas_from_document(jdoc)
    assert doc.active_tile_mask(doc.visible_layers(), rect) is None
    assert bool(_device_mask(doc, rect).all())


@pytest.mark.parametrize("size", [(1, 1), (63, 65), (64, 128), (200, 70)])
def test_device_tile_mask_on_canvas_sizes_off_the_tile_grid(size):
    h, w = size
    rng = np.random.default_rng(h * w)
    doc = tcanvas.Canvas(width=w, height=h)
    for k in range(2):
        layer = tcanvas.Layer.new(f"L{k}", w, h)
        layer.pixels = _rand(rng, (h, w, 4))
        layer.pixels[:, : w // 2] = 0
        layer.pixels[h // 2:, :] = 0
        doc.layers.append(layer)
    for rect in (None, (h // 3, w // 3, h - h // 3, w - w // 3)):
        host = doc.active_tile_mask(doc.visible_layers(), rect)
        got = _device_mask(doc, rect)
        if host is None:
            assert bool(got.all())
        else:
            np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("preview", [(0, "blend"), (14, "blend"), (0, "eraser"),
                                     (0, "replace")])
def test_flatten_with_an_adjustment_layer_and_a_preview_matches_jax(preview):
    """The flatten's device-built tile mask under each preview variant, the
    preview reaching into the tile that is empty in every layer; whole
    canvas, composite_device and a dirty rect that cuts tiles."""
    jdoc = _document(20, ADJUSTMENTS[4], preview)  # invert: an unmasked empty tile shows
    jdoc.preview[70:90, 100:120] = 200
    # a tile that only the active layer fills: a replacing preview drops the
    # layer's alpha from the fold, but the mask still reads the raw layer
    for k, layer in enumerate(jdoc.layers):
        layer.pixels[0:64, 128:] = 180 if k == 4 else 0
        layer.pixels[128:, 0:64] = 0  # one tile stays empty whatever the preview does
    doc = tcanvas.canvas_from_document(jdoc)
    want = jdoc.composite()
    np.testing.assert_array_equal(doc.composite(device="cpu"), want)
    cache, jcache = tdevice.DeviceLayerCache("cpu"), jdevice.DeviceLayerCache()
    full = tdevice.composite_device(doc, cache)
    np.testing.assert_array_equal(full.numpy(), want)
    jfull = jdevice.composite_device(jdoc, jcache)
    pv = jdoc.preview.copy()
    pv[70:90, 100:120] = 0  # the empty tile loses its only data
    pv[30:50, 60:100] = 77
    jdoc.preview = pv
    doc.preview = pv.copy()
    # the rect cuts tiles on its left and top and covers the emptied tile
    updated = tdevice.composite_dirty_rect(doc, cache, full, (55, 25, 127, 127))
    jupdated = jdevice.composite_dirty_rect(jdoc, jcache, jfull, (55, 25, 127, 127))
    np.testing.assert_array_equal(updated.numpy(), np.asarray(jupdated))
    np.testing.assert_array_equal(updated.numpy(), doc.composite(device="cpu"))
    assert (updated.numpy()[64:128, 64:128] == 0).all()


def test_flatten_builds_its_tile_mask_without_the_host_pass(monkeypatch):
    """The flatten never calls the host definition of the mask."""
    doc = tcanvas.canvas_from_document(_document(43, ADJUSTMENTS[2]))
    want = doc.composite(device="cpu")

    def no_host_mask(self, vis, rect=None):
        raise AssertionError("the flatten ran the host pass over the layers")

    monkeypatch.setattr(tcanvas.Canvas, "active_tile_mask", no_host_mask)
    np.testing.assert_array_equal(doc.composite(device="cpu"), want)
    assert (want[64:128, 64:128] == 0).all()


def test_composite_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    doc = tcanvas.canvas_from_document(_document(23))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        doc.composite()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.DeviceLayerCache()


def test_canvas_from_document_carries_every_field():
    jdoc = _document(24, ADJUSTMENTS[5], (2, "blend"))
    jdoc.selection = np.zeros((H, W), np.uint8)
    jdoc.layers[0].pixel_format = jdeep.PixelFormat.RGBA_U16
    jdoc.layers[0].deep_pixels = jdeep.DeepRgbaBuffer.from_rgba8(
        jdoc.layers[0].pixels, jdeep.PixelFormat.RGBA_U16)
    jdoc.layers[0].hdr_metadata = jdeep.HdrMetadata(True, 1000.0, 203.0, "pq")
    jdoc.layers[0].source_metadata = jdeep.ImageMetadata("png", "a.png", None, [("k", "v")])
    doc = tcanvas.canvas_from_document(jdoc)
    assert (doc.width, doc.height, doc.active_layer_index) == (W, H, 4)
    assert [dataclasses.astuple(f) for f in doc.folders] == \
        [dataclasses.astuple(f) for f in jdoc.folders]
    np.testing.assert_array_equal(doc.selection, jdoc.selection)
    np.testing.assert_array_equal(doc.preview, jdoc.preview)
    assert int(doc.preview_blend_mode) == 2
    for a, b in zip(doc.layers, jdoc.layers):
        assert (a.name, a.visible, a.opacity, int(a.blend_mode), a.mask_enabled,
                a.folder_id, a.content) == (b.name, b.visible, b.opacity,
                                            int(b.blend_mode), b.mask_enabled,
                                            b.folder_id, b.content)
        np.testing.assert_array_equal(a.pixels, b.pixels)
        assert (a.mask is None) == (b.mask is None)
    base = doc.layers[0]
    assert base.pixel_format == tdeep.PixelFormat.RGBA_U16
    np.testing.assert_array_equal(base.deep_pixels.data, jdoc.layers[0].deep_pixels.data)
    assert base.hdr_metadata == tdeep.HdrMetadata(True, 1000.0, 203.0, "pq")
    assert base.source_metadata.png_text_chunks == [("k", "v")]
    assert doc.layers[3].adjustment.green == (0.1, 1.2, 0.0, 0.1)
    # the port's arrays are its own
    doc.layers[0].pixels[0, 0] = 7
    assert not (jdoc.layers[0].pixels[0, 0] == 7).all()


@pytest.mark.parametrize("adj", range(len(ADJUSTMENTS)))
@pytest.mark.parametrize("opacity", [0.0, 0.35, 1.0])
def test_adjustment_apply_matches_jax(adj, opacity):
    rng = np.random.default_rng(adj)
    px = _rand(rng, (33, 17, 4))
    jadj = jdeep.AdjustmentLayerData(**ADJUSTMENTS[adj])
    tadj = tdeep.AdjustmentLayerData(**ADJUSTMENTS[adj])
    t = torch.from_numpy(px)
    np.testing.assert_array_equal(tadj.apply(t).numpy(), jadj.apply(px))
    np.testing.assert_array_equal(tadj.apply_with_opacity(t, opacity).numpy(),
                                  jadj.apply_with_opacity(px, opacity))
    np.testing.assert_array_equal(
        np.asarray(jadj.apply_with_opacity(jnp.asarray(px), opacity, xp=jnp)),
        tadj.apply_with_opacity(t, opacity).numpy())
    f = px.astype(np.float32) / np.float32(255.0) * np.float32(1.7)
    np.testing.assert_array_equal(tadj.apply_to_f32_with_opacity(f, opacity),
                                  jadj.apply_to_f32_with_opacity(f, opacity))


@pytest.mark.parametrize("fmt", list(tdeep.PixelFormat))
def test_deep_buffers_match_jax(fmt):
    rng = np.random.default_rng(3)
    px = _rand(rng, (9, 11, 4))
    a = tdeep.DeepRgbaBuffer.from_rgba8(px, fmt)
    b = jdeep.DeepRgbaBuffer.from_rgba8(px, jdeep.PixelFormat(fmt.value))
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.to_rgba8(11, 9), b.to_rgba8(11, 9))
    v = (rng.random(64) * 3 - 1).astype(np.float32)
    np.testing.assert_array_equal(tdeep.f32_to_f16_bits(v), jdeep.f32_to_f16_bits(v))
    x = rng.random((5, 4)).astype(np.float32) * 4
    np.testing.assert_array_equal(tdeep.reinhard_tone_map(x, 1.0), jdeep.reinhard_tone_map(x, 1.0))


def test_composite_device_matches_jax():
    jdoc = _document(30, ADJUSTMENTS[3], (1, "blend"))
    doc = tcanvas.canvas_from_document(jdoc)
    got = tdevice.composite_device(doc, tdevice.DeviceLayerCache("cpu"))
    want = np.asarray(jdevice.composite_device(jdoc, jdevice.DeviceLayerCache()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), doc.composite(device="cpu"))


def test_composite_dirty_rect_matches_jax_and_the_full_composite():
    """tests/test_document.py's dirty-rect cases: an edit under a masked
    layer crossing the empty tile, then a moved preview."""
    jdoc = _document(31, ADJUSTMENTS[4], (0, "blend"))
    doc = tcanvas.canvas_from_document(jdoc)
    cache, jcache = tdevice.DeviceLayerCache("cpu"), jdevice.DeviceLayerCache()
    full = tdevice.composite_device(doc, cache)
    jfull = jdevice.composite_device(jdoc, jcache)
    rng = np.random.default_rng(32)
    px = jdoc.layers[1].pixels.copy()
    px[30:90, 50:110] = _rand(rng, (60, 60, 4))
    px[64:128, 64:128] = 0
    jdoc.layers[1].pixels = px
    doc.layers[1].pixels = px.copy()
    updated = tdevice.composite_dirty_rect(doc, cache, full, (50, 30, 109, 89))
    jupdated = jdevice.composite_dirty_rect(jdoc, jcache, jfull, (50, 30, 109, 89))
    np.testing.assert_array_equal(updated.numpy(), np.asarray(jupdated))
    np.testing.assert_array_equal(updated.numpy(), doc.composite(device="cpu"))

    pv = np.zeros((H, W, 4), np.uint8)
    pv[60:100, 20:60] = _rand(rng, (40, 40, 4))
    jdoc.preview = pv
    doc.preview = pv.copy()
    updated2 = tdevice.composite_dirty_rect(doc, cache, updated, (10, 10, 109, 109))
    jupdated2 = jdevice.composite_dirty_rect(jdoc, jcache, jupdated, (10, 10, 109, 109))
    np.testing.assert_array_equal(updated2.numpy(), np.asarray(jupdated2))
    np.testing.assert_array_equal(updated2.numpy(), doc.composite(device="cpu"))
    # a degenerate rect is a no-op
    same = tdevice.composite_dirty_rect(doc, cache, updated2.clone(), (50, 50, 10, 10))
    np.testing.assert_array_equal(same.numpy(), updated2.numpy())


def test_layer_cache_revalidates_by_identity_and_evicts_dead_layers():
    import gc

    cache = tdevice.DeviceLayerCache("cpu")
    layer = tcanvas.Layer.new("a", 8, 4, (1, 2, 3, 4))
    first = cache.get(layer)
    assert cache.get(layer) is first
    layer.pixels = layer.pixels.copy()  # a new array: uploaded again
    assert cache.get(layer) is not first
    layer.mask = np.zeros((4, 8), np.uint8)
    cache.get(layer, slot="mask")
    assert cache.resident_count() == 1
    assert cache.memory_bytes() == 8 * 4 * 4 + 8 * 4
    del layer
    gc.collect()
    assert cache.resident_count() == 0


@pytest.mark.parametrize("slot", ["pixels", "mask"])
def test_layer_cache_generation_invalidate_and_clear_match_jax(slot):
    """DeviceLayerCache's whole interface against the JAX package's on one
    sequence of edits: get with and without a generation counter (a changed
    counter uploads again even when the host array is the same object; a
    get without one trusts the array's identity), a replaced array,
    invalidate (both slots of one layer) and clear.  Each step records
    whether the cache served the entry it held, and what it serves."""
    def run(module, layer_cls):
        cache = module.DeviceLayerCache("cpu") if module is tdevice else module.DeviceLayerCache()
        a = layer_cls.new("a", 8, 4, (1, 2, 3, 4))
        b = layer_cls.new("b", 8, 4, (9, 9, 9, 9))
        for layer in (a, b):
            layer.mask = np.full((4, 8), 7, np.uint8)
        steps = [("get", a, None), ("get", a, None), ("get", a, 1), ("get", a, 1),
                 ("get", a, 2), ("get", a, None), ("get", a, 2), ("get", b, 5),
                 ("replace", a, None), ("get", a, 2), ("get", a, 2), ("invalidate", a, None),
                 ("get", a, 2), ("get", b, 5), ("clear", None, None), ("get", b, 5),
                 ("get", a, None)]
        held, served = [], []
        for op, layer, gen in steps:
            if op == "replace":
                setattr(layer, slot, getattr(layer, slot).copy())
            elif op == "invalidate":
                cache.invalidate(layer)
            elif op == "clear":
                cache.clear()
            else:
                before = cache._cache.get((id(layer), slot))
                out = cache.get(layer, gen, slot=slot)
                held.append(before is not None and out is before[2])
                served.append(np.asarray(out).copy())
        return held, served, cache.resident_count(), cache.memory_bytes()

    held, served, resident, nbytes = run(tdevice, tcanvas.Layer)
    jheld, jserved, jresident, jnbytes = run(jdevice, jcanvas.Layer)
    assert held == jheld
    assert held == [False, True, False, True, False, True, True, False, False, True,
                    False, True, False, False]
    assert (resident, nbytes) == (jresident, jnbytes)
    for got, want in zip(served, jserved):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rect", [(40, 40, 63, 63), (40, 40, 100, 70)])
def test_dirty_rect_over_a_corner_of_an_emptied_tile_equals_the_full_flatten(rect):
    """ROADMAP C4: tile (0..64, 0..64) holds data only in its corner
    (40..64, 40..64) of one layer, under an invert adjustment layer.  An
    edit erases that corner and the dirty rect covers it: the tile turns
    empty, and the mask clears the whole tile, also outside the rect.  The
    splice must equal the full flatten, which equals the JAX package's
    full composite."""
    jdoc = _document(33, ADJUSTMENTS[4])
    for layer in jdoc.layers:
        if layer.content != "adjustment":
            layer.pixels[0:64, 0:64] = 0
    jdoc.layers[1].pixels[40:64, 40:64] = 90
    doc = tcanvas.canvas_from_document(jdoc)
    cache = tdevice.DeviceLayerCache("cpu")
    full = tdevice.composite_device(doc, cache)
    assert (full.numpy()[0:40, 0:40, 0:3] > 0).all()  # an active tile, inverted
    px = doc.layers[1].pixels.copy()
    px[40:64, 40:64] = 0
    doc.layers[1].pixels = px
    jdoc.layers[1].pixels = px.copy()
    updated = tdevice.composite_dirty_rect(doc, cache, full, rect)
    want = doc.composite(device="cpu")
    np.testing.assert_array_equal(want, jdoc.composite())
    np.testing.assert_array_equal(updated.numpy(), want)
    assert (updated.numpy()[0:64, 0:64] == 0).all()


def test_dirty_rect_of_whole_tiles_matches_the_jax_dirty_rect():
    """A rect that lies on the tile grid is not grown: the splice equals
    the JAX package's dirty-rect path and the full flatten."""
    jdoc = _document(34, ADJUSTMENTS[2])
    doc = tcanvas.canvas_from_document(jdoc)
    cache, jcache = tdevice.DeviceLayerCache("cpu"), jdevice.DeviceLayerCache()
    full = tdevice.composite_device(doc, cache)
    jfull = jdevice.composite_device(jdoc, jcache)
    px = jdoc.layers[0].pixels.copy()
    px[64:128, 0:64] = np.random.default_rng(35).integers(0, 256, (64, 64, 4), np.uint8)
    jdoc.layers[0].pixels = px
    doc.layers[0].pixels = px.copy()
    updated = tdevice.composite_dirty_rect(doc, cache, full, (0, 64, 63, 127))
    jupdated = jdevice.composite_dirty_rect(jdoc, jcache, jfull, (0, 64, 63, 127))
    np.testing.assert_array_equal(updated.numpy(), np.asarray(jupdated))
    np.testing.assert_array_equal(updated.numpy(), doc.composite(device="cpu"))


@pytest.mark.parametrize("ops", [
    [("resize_image", 97, 61, "lanczos3", (0, 0)), ("resize_canvas", 120, 90, "bilinear", (1, 1))],
    [("resize_canvas", 70, 140, "bilinear", (2, 0)), ("resize_image", 40, 150, "bicubic", (0, 0))],
    [("resize_image", 150, 130, "nearest", (0, 0)), ("rot90cw", 0, 0, "bilinear", (0, 0))],
])
def test_resize_replay_on_a_layered_document_matches_jax(ops):
    """apply_canvas_ops replays resize_image / resize_canvas on every layer
    but the active one (layer masks cropped or zero-padded to the new
    size), as the JAX engine does; the flatten of the result equals the
    JAX package's."""
    from paintfe_tpu.scripting import api as japi
    from paintfe_tpu.scripting import engine as jengine
    from paintfe_tpu_torch.ops import transform as tfm
    from paintfe_tpu_torch.scripting import api as tapi
    from paintfe_tpu_torch.scripting import engine as tengine

    jdoc = _document(36, ADJUSTMENTS[2])
    doc = tcanvas.canvas_from_document(jdoc)
    active = jdoc.active_layer_index
    for kind, w, h, filt, anchor in ops:  # the script's own layer, as the script did it
        px = jdoc.layers[active].pixels
        if kind == "resize_image":
            px = tfm.resize(px, w, h, filt)
        elif kind == "resize_canvas":
            px = tfm.resize_canvas(px, w, h, anchor)
        else:
            px = tfm.rotate_90cw(px)
        jdoc.layers[active].pixels = px
        doc.layers[active].pixels = px.copy()
    jengine.apply_canvas_ops(jdoc, [japi.CanvasOpRequest(k, w, h, f, a)
                                    for k, w, h, f, a in ops], active)
    tengine.apply_canvas_ops(doc, [tapi.CanvasOpRequest(k, w, h, f, a)
                                   for k, w, h, f, a in ops], active)
    assert (doc.width, doc.height) == (jdoc.width, jdoc.height)
    for layer, jlayer in zip(doc.layers, jdoc.layers):
        np.testing.assert_array_equal(layer.pixels, jlayer.pixels)
        if jlayer.mask is not None:
            np.testing.assert_array_equal(layer.mask, jlayer.mask)
    np.testing.assert_array_equal(doc.composite(device="cpu"), jdoc.composite())
