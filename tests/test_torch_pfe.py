"""The port's .pfe container and deep export (paintfe_tpu_torch.io.pfe,
io/deep_export.py) against the JAX package's: load_pfe of V0-V3 files the
JAX package wrote equals its own load field by field, save_pfe writes the
same bytes, and prepare_export_image / prepared_to_rgba8 / the 16-bit PNG
and TIFF writers give the JAX package's arrays and bytes.  Tolerance 0."""

import numpy as np
import pytest
import torch

from paintfe_tpu.core import canvas as jcanvas
from paintfe_tpu.core import deep as jdeep
from paintfe_tpu.core.blend import BlendMode as JMode
from paintfe_tpu.io import deep_export as jexport
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.io import deep_export as texport
from paintfe_tpu_torch.io import pfe as tpfe

H, W = 70, 90


def _raster_doc(seed, n=3):
    rng = np.random.default_rng(seed)
    c = jcanvas.Canvas.new(W, H)
    c.layers = []
    for i in range(n):
        layer = jcanvas.Layer.new(f"L{i} ünï", W, H)
        px = rng.integers(0, 256, (H, W, 4), np.uint8)
        px[:64, :64, 3] = 0 if i else 255  # one empty chunk above the base
        layer.pixels = jcanvas.canonicalize_tiles(px)
        layer.blend_mode = JMode((i * 7) % 25)
        layer.opacity = [1.0, 0.55, 0.8][i % 3]
        layer.visible = i != 1 or n < 3
        c.layers.append(layer)
    c.active_layer_index = n - 1
    return c


def _v3_doc(seed):
    c = _raster_doc(seed, 4)
    c.folders = [jcanvas.LayerFolder(id=2, name="f", visible=False, expanded=False),
                 jcanvas.LayerFolder(id=5, name="g")]
    c.layers[3].folder_id = 2
    adj = jcanvas.Layer.new("bc", W, H)
    adj.content = "adjustment"
    adj.adjustment = jdeep.AdjustmentLayerData(kind=jdeep.AdjustmentKind.BRIGHTNESS_CONTRAST,
                                               brightness=12.5, contrast=-30.0)
    adj.opacity = 0.6
    c.layers.insert(2, adj)
    mixer = jcanvas.Layer.new("mix", W, H)
    mixer.content = "adjustment"
    mixer.adjustment = jdeep.AdjustmentLayerData(kind=jdeep.AdjustmentKind.CHANNEL_MIXER,
                                                 red=(0.2, 0.3, 0.4, 0.5))
    mixer.folder_id = 5
    c.layers.append(mixer)
    base = c.layers[0]
    base.pixel_format = jdeep.PixelFormat.RGBA_U16
    base.deep_pixels = jdeep.DeepRgbaBuffer.from_rgba8(base.pixels, jdeep.PixelFormat.RGBA_U16)
    base.hdr_metadata = jdeep.HdrMetadata(True, 1000.0, None, "pq")
    base.source_metadata = jdeep.ImageMetadata("png", "in.png", "sRGB", [("a", "b")])
    return c


def _v0_bytes(doc):
    """A V0 container (full-frame layers), written with the JAX package's
    bincode writer: the JAX package reads V0 but never writes it."""
    w = jpfe._Writer()
    w.string("PFE0")
    w.u32(doc.width)
    w.u32(doc.height)
    w.u64(doc.active_layer_index)
    w.u64(len(doc.layers))
    for layer in doc.layers:
        w.string(layer.name)
        w.u8(1 if layer.visible else 0)
        w.f32(layer.opacity)
        w.u8(int(layer.blend_mode) if int(layer.blend_mode) else 31)  # 31: out of range
        w.bytes_vec(np.ascontiguousarray(layer.pixels).tobytes())
    return w.getvalue()


def _text_doc(seed, payload):
    c = _raster_doc(seed, 2)
    c.layers[1].content = "text"
    if payload:
        from paintfe_tpu.ops.text_layer import TextLayerData

        c.layers[1].text_data = TextLayerData()
    return c


def _assert_same(t, j):
    assert (t.width, t.height, t.active_layer_index) == (j.width, j.height, j.active_layer_index)
    assert [(f.id, f.name, f.visible, f.expanded) for f in t.folders] == \
        [(f.id, f.name, f.visible, f.expanded) for f in j.folders]
    assert len(t.layers) == len(j.layers)
    for a, b in zip(t.layers, j.layers):
        assert (a.name, a.visible, a.opacity, int(a.blend_mode), a.folder_id, a.content) == \
            (b.name, b.visible, b.opacity, int(b.blend_mode), b.folder_id, b.content)
        np.testing.assert_array_equal(a.pixels, b.pixels)
        assert (a.adjustment is None) == (b.adjustment is None)
        if a.adjustment is not None:
            assert int(a.adjustment.kind) == int(b.adjustment.kind)
            assert (a.adjustment.ev, a.adjustment.brightness, a.adjustment.contrast,
                    a.adjustment.red, a.adjustment.green, a.adjustment.blue,
                    a.adjustment.alpha) == (
                b.adjustment.ev, b.adjustment.brightness, b.adjustment.contrast,
                b.adjustment.red, b.adjustment.green, b.adjustment.blue, b.adjustment.alpha)
        fa, fb = a.pixel_format, b.pixel_format
        assert (None if fa is None else fa.value) == (None if fb is None else fb.value)
        assert (a.deep_pixels is None) == (b.deep_pixels is None)
        if a.deep_pixels is not None:
            assert a.deep_pixels.format.value == b.deep_pixels.format.value
            np.testing.assert_array_equal(a.deep_pixels.data, b.deep_pixels.data)
        for x, y in ((a.hdr_metadata, b.hdr_metadata), (a.source_metadata, b.source_metadata)):
            assert (x is None) == (y is None)
            if x is not None:
                assert vars(x) == vars(y)


DOCS = {
    "v1": lambda tmp: _raster_doc(1),
    "v1-single": lambda tmp: _raster_doc(2, 1),
    "v2-text-without-payload": lambda tmp: _text_doc(3, False),
    "v3": lambda tmp: _v3_doc(4),
}


@pytest.mark.parametrize("kind", sorted(DOCS))
def test_load_and_save_match_jax(tmp_path, kind):
    jdoc = DOCS[kind](tmp_path)
    src = tmp_path / "j.pfe"
    jpfe.save_pfe(jdoc, str(src))
    magic = {"v1": b"PFE1", "v1-single": b"PFE1", "v2-text-without-payload": b"PFE2",
             "v3": b"PFE3"}[kind]
    assert src.read_bytes()[8:12] == magic
    tdoc = tpfe.load_pfe(str(src))
    _assert_same(tdoc, jpfe.load_pfe(str(src)))
    # the port writes the bytes the JAX package wrote, from what it loaded
    # and from the carried-across document alike
    tpfe.save_pfe(tdoc, str(tmp_path / "t.pfe"))
    assert (tmp_path / "t.pfe").read_bytes() == src.read_bytes()
    tpfe.save_pfe(canvas_from_document(jdoc), str(tmp_path / "c.pfe"))
    assert (tmp_path / "c.pfe").read_bytes() == src.read_bytes()


def test_load_v0_matches_jax(tmp_path):
    src = tmp_path / "v0.pfe"
    src.write_bytes(_v0_bytes(_raster_doc(5)))
    _assert_same(tpfe.load_pfe(str(src)), jpfe.load_pfe(str(src)))


@pytest.mark.parametrize("blob", [b"", b"PFE9xxxx", b"\x04\0\0\0\0\0\0\0PFE1\x05\0"])
def test_corrupt_files_raise_pfe_error(tmp_path, blob):
    (tmp_path / "bad.pfe").write_bytes(blob)
    with pytest.raises(tpfe.PfeError):
        tpfe.load_pfe(str(tmp_path / "bad.pfe"))
    with pytest.raises(jpfe.PfeError):
        jpfe.load_pfe(str(tmp_path / "bad.pfe"))


def test_text_payloads_are_not_yet_ported(tmp_path):
    """V2 and V3 containers with text payloads, once refused, now load: the
    port's text data serializes to the JAX package's JSON, and the port
    writes the JAX package's bytes back."""
    from paintfe_tpu.ops.text_layer import TextLayerData, text_data_to_json
    from paintfe_tpu_torch.ops.text_layer import text_data_to_json as t_to_json

    jpfe.save_pfe(_text_doc(6, True), str(tmp_path / "t2.pfe"))
    v3 = _v3_doc(7)
    v3.layers[1].content = "text"
    v3.layers[1].text_data = TextLayerData()
    jpfe.save_pfe(v3, str(tmp_path / "t3.pfe"))
    for name in ("t2.pfe", "t3.pfe"):
        tdoc = tpfe.load_pfe(str(tmp_path / name))
        jdoc = jpfe.load_pfe(str(tmp_path / name))
        texts = [(l.name, text_data_to_json(l.text_data)) for l in jdoc.layers
                 if l.text_data is not None]
        assert texts
        assert [(l.name, t_to_json(l.text_data)) for l in tdoc.layers
                if l.text_data is not None] == texts
        tpfe.save_pfe(tdoc, str(tmp_path / f"port_{name}"))
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / name).read_bytes()


def _deep_doc(fmt, hdr=False, adjustment_only=False, single=False):
    rng = np.random.default_rng(8)
    c = jcanvas.Canvas.new(W, H)
    base = c.layers[0]
    base.pixels = rng.integers(0, 256, (H, W, 4), np.uint8)
    base.pixel_format = fmt
    base.deep_pixels = jdeep.DeepRgbaBuffer.from_rgba8(base.pixels, fmt)
    if hdr:
        base.hdr_metadata = jdeep.HdrMetadata(True)
    if single:
        return c
    top = jcanvas.Layer.new("top", W, H)
    if adjustment_only:
        top.content = "adjustment"
        top.adjustment = jdeep.AdjustmentLayerData(kind=jdeep.AdjustmentKind.EXPOSURE, ev=1.5)
    else:
        top.pixels = rng.integers(0, 256, (H, W, 4), np.uint8)
        top.blend_mode = JMode.OVERLAY
    c.layers.append(top)
    return c


EXPORTS = [
    ("u8-raster", lambda: _raster_doc(9)),
    ("u16-single", lambda: _deep_doc(jdeep.PixelFormat.RGBA_U16, single=True)),
    ("f16-single", lambda: _deep_doc(jdeep.PixelFormat.RGBA_F16, single=True)),
    ("f32-single", lambda: _deep_doc(jdeep.PixelFormat.RGBA_F32, single=True)),
    ("u16-adjusted", lambda: _deep_doc(jdeep.PixelFormat.RGBA_U16, adjustment_only=True)),
    ("f32-adjusted-hdr", lambda: _deep_doc(jdeep.PixelFormat.RGBA_F32, True, True)),
    ("u16-composite", lambda: _deep_doc(jdeep.PixelFormat.RGBA_U16)),
    ("f16-composite", lambda: _deep_doc(jdeep.PixelFormat.RGBA_F16)),
]


@pytest.mark.parametrize("name,make", EXPORTS, ids=[n for n, _ in EXPORTS])
def test_prepare_export_image_matches_jax(tmp_path, name, make):
    jdoc = make()
    doc = canvas_from_document(jdoc)
    assert texport.needs_deep_export(doc) == jexport.needs_deep_export(jdoc)
    want = jexport.prepare_export_image(jdoc)
    got = texport.prepare_export_image(doc, device="cpu")
    assert (got.kind, got.width, got.height) == (want.kind, want.width, want.height)
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(texport.prepared_to_rgba8(got), jexport.prepared_to_rgba8(want))
    for fmt in ("png", "tiff"):
        texport.encode_prepared_and_write(got, tmp_path / f"t.{fmt}", fmt)
        jexport.encode_prepared_and_write(want, tmp_path / f"j.{fmt}", fmt)
        assert (tmp_path / f"t.{fmt}").read_bytes() == (tmp_path / f"j.{fmt}").read_bytes()


def test_hdr_tone_map_matches_jax():
    rng = np.random.default_rng(10)
    data = (rng.random((H, W, 4)) * 2.5).astype(np.float32)
    prep = texport.PreparedExport("rgbaf32", W, H, data)
    np.testing.assert_array_equal(texport.prepared_to_rgba8(prep),
                                  jexport.prepared_to_rgba8(jexport.PreparedExport(
                                      "rgbaf32", W, H, data)))


@pytest.mark.parametrize("compression", ["none", "lzw", "deflate"])
def test_16_bit_writers_give_the_jax_bytes(tmp_path, compression):
    rng = np.random.default_rng(11)
    u16 = rng.integers(0, 65536, (13, 21, 4), np.uint16)
    u16[:4] = 1000  # runs for the LZW dictionary
    texport.write_png16(tmp_path / "t.png", 21, 13, u16)
    jexport.write_png16(tmp_path / "j.png", 21, 13, u16)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    texport.write_tiff16(tmp_path / "t.tif", 21, 13, u16, compression)
    jexport.write_tiff16(tmp_path / "j.tif", 21, 13, u16, compression)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    f = rng.random((13, 21, 4)).astype(np.float32)
    texport.write_tiff_f32(tmp_path / "t32.tif", 21, 13, f)
    jexport.write_tiff_f32(tmp_path / "j32.tif", 21, 13, f)
    assert (tmp_path / "t32.tif").read_bytes() == (tmp_path / "j32.tif").read_bytes()


def test_lzw_encoder_matches_jax_across_table_resets():
    rng = np.random.default_rng(12)
    data = bytes(rng.integers(0, 7, 30000, np.uint8)) + bytes(rng.integers(0, 256, 9000, np.uint8))
    assert texport._lzw_encode(data) == jexport._lzw_encode(data)
    assert jexport._lzw_decode(texport._lzw_encode(data), len(data)) == data
