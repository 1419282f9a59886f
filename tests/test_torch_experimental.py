"""The port's experimental features (paintfe_tpu_torch.core.deep,
io.deep_export, io.pfe V2/V3, adjustment layers) on the cases of
tests/test_experimental.py: each document is built the same way in both
packages, and the port's composites, deep buffers, prepared exports and
written files equal the JAX package's at tolerance 0 (files byte for
byte), besides the JAX tests' own expectations.  The native byte codecs
(native/bytecodec.cpp) are held to the port's plain oracles
(png_defilter_plain, _lzw_encode_plain) and to the JAX package's bytes."""

import types

import numpy as np
import pytest
from PIL import Image

import paintfe_tpu
import paintfe_tpu_torch
from paintfe_tpu import cli as jcli
from paintfe_tpu_torch import cli as tcli

from test_experimental import _forward_filter_png16, _write_png16_filtered


def package(root):
    """The modules and classes of one package that these cases use."""
    import importlib

    name = root.__name__
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    canvas, deep, text = mod("core.canvas"), mod("core.deep"), mod("ops.text_layer")
    return types.SimpleNamespace(
        Canvas=canvas.Canvas, Layer=canvas.Layer, LayerFolder=canvas.LayerFolder,
        deep=deep, text=text, fixtures=mod("core.fixtures"), pfe=mod("io.pfe"),
        de=mod("io.deep_export"), port=root is paintfe_tpu_torch)


J, T = package(paintfe_tpu), package(paintfe_tpu_torch)


def dev(p):
    """The device keyword of a port entry point: the CPU here."""
    return {"device": "cpu"} if p.port else {}


def same_layers(a, b):
    assert (a.width, a.height, len(a.layers)) == (b.width, b.height, len(b.layers))
    for x, y in zip(a.layers, b.layers):
        np.testing.assert_array_equal(x.pixels, np.asarray(y.pixels))


def saved_both(tmp_path, build, name):
    """build(package) saved by each package's save_pfe: the same bytes.
    Returns the port's path and canvas."""
    tc, jc = build(T), build(J)
    T.pfe.save_pfe(tc, str(tmp_path / f"t_{name}"))
    J.pfe.save_pfe(jc, str(tmp_path / f"j_{name}"))
    assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    return tmp_path / f"t_{name}", tc


@pytest.mark.parametrize("fmt", ["RGBA_U8", "RGBA_U16", "RGBA_F16", "RGBA_F32"])
def test_deep_formats_round_trip(fmt):
    assert [f.name for f in T.deep.PixelFormat] == [f.name for f in J.deep.PixelFormat]
    img = np.zeros((2, 2, 4), np.uint8)
    img[...] = [17, 128, 251, 255]
    deep = T.deep.DeepRgbaBuffer.from_rgba8(img, T.deep.PixelFormat[fmt])
    jdeep = J.deep.DeepRgbaBuffer.from_rgba8(img, J.deep.PixelFormat[fmt])
    assert T.deep.PixelFormat(deep.format) == T.deep.PixelFormat[fmt]
    assert deep.data.dtype == jdeep.data.dtype
    np.testing.assert_array_equal(deep.data, jdeep.data)
    back = deep.to_rgba8(2, 2)
    np.testing.assert_array_equal(back, jdeep.to_rgba8(2, 2))
    px = back[0, 0]
    assert abs(int(px[0]) - 17) <= 1
    assert abs(int(px[1]) - 128) <= 1
    assert abs(int(px[2]) - 251) <= 1
    assert px[3] == 255


def test_f16_bits_conversion():
    vals = np.array([0.0, 0.5, 1.0, 0.12345], np.float32)
    bits = T.deep.f32_to_f16_bits(vals)
    np.testing.assert_array_equal(bits, J.deep.f32_to_f16_bits(vals))
    back = T.deep.f16_bits_to_f32(bits)
    np.testing.assert_array_equal(back, J.deep.f16_bits_to_f32(bits))
    assert np.abs(back - vals).max() < 1e-3
    assert bits[0] == 0 and bits[2] == 0x3C00


def test_reinhard_tonemap():
    x = np.array([4.0, 1.0, 0.0, 0.5019608], np.float32)
    px = T.deep.reinhard_tone_map(x, 1.0)
    np.testing.assert_array_equal(px, J.deep.reinhard_tone_map(x, 1.0))
    assert px[0] > px[1]
    assert px[2] == 0
    assert px[3] == 128
    assert px[0] < 255


@pytest.mark.parametrize("fill,kind,params,opacity,expected", [
    ((10, 20, 30, 255), "INVERT", {}, 1.0, [245, 235, 225, 255]),
    ((128, 128, 128, 255), "INVERT", {}, 0.5, [128, 128, 128, 255]),
    ((50, 100, 200, 255), "EXPOSURE", {"ev": 1.0}, 1.0, [100, 200, 255, 255]),
], ids=["invert", "invert_half_opacity", "exposure"])
def test_adjustment_layer_composite(fill, kind, params, opacity, expected):
    def build(p):
        c = p.Canvas.from_image(p.fixtures.solid(4, 4, fill))
        adj = p.Layer.new(kind.lower(), 4, 4)
        adj.content = "adjustment"
        adj.adjustment = p.deep.AdjustmentLayerData(kind=p.deep.AdjustmentKind[kind], **params)
        adj.opacity = opacity
        c.layers.append(adj)
        return c

    c = build(T)
    out = c.composite(device="cpu")
    np.testing.assert_array_equal(out, np.asarray(build(J).composite()))
    np.testing.assert_array_equal(out[0, 0], expected)
    np.testing.assert_array_equal(c.layers[0].pixels[0, 0], fill)


def test_pfe3_round_trip(tmp_path):
    def build(p):
        c = p.Canvas.from_image(p.fixtures.test_gradient(64, 64))
        c.folders.append(p.LayerFolder(id=3, name="group", visible=True))
        base = c.layers[0]
        base.folder_id = 3
        base.pixel_format = p.deep.PixelFormat.RGBA_F32
        base.deep_pixels = p.deep.DeepRgbaBuffer.from_rgba8(base.pixels,
                                                            p.deep.PixelFormat.RGBA_F32)
        base.hdr_metadata = p.deep.HdrMetadata(enabled=True, max_luminance_nits=1000.0)
        base.source_metadata = p.deep.ImageMetadata(source_format="png")
        adj = p.Layer.new("bc", 64, 64)
        adj.content = "adjustment"
        adj.adjustment = p.deep.AdjustmentLayerData(
            kind=p.deep.AdjustmentKind.BRIGHTNESS_CONTRAST, brightness=10.0, contrast=5.0)
        c.layers.append(adj)
        return c

    path, c = saved_both(tmp_path, build, "exp.pfe")
    loaded = T.pfe.load_pfe(str(path))
    same_layers(loaded, J.pfe.load_pfe(str(path)))
    assert loaded.layers[0].pixel_format == T.deep.PixelFormat.RGBA_F32
    assert loaded.layers[0].hdr_metadata.enabled
    assert loaded.layers[0].hdr_metadata.max_luminance_nits == 1000.0
    assert loaded.layers[0].folder_id == 3
    assert loaded.folders[0].name == "group"
    assert loaded.layers[1].content == "adjustment"
    assert loaded.layers[1].adjustment.kind == T.deep.AdjustmentKind.BRIGHTNESS_CONTRAST
    assert loaded.layers[1].adjustment.brightness == 10.0
    np.testing.assert_array_equal(loaded.layers[0].deep_pixels.data, c.layers[0].deep_pixels.data)
    np.testing.assert_array_equal(loaded.layers[0].pixels, c.layers[0].pixels)
    np.testing.assert_array_equal(loaded.composite(device="cpu"),
                                  np.asarray(J.pfe.load_pfe(str(path)).composite()))


def test_16bit_deep_preserved_through_pfe(tmp_path):
    def build(p):
        c = p.Canvas.from_image(p.fixtures.test_gradient(8, 8))
        c.layers[0].pixel_format = p.deep.PixelFormat.RGBA_U16
        deep = p.deep.DeepRgbaBuffer.from_rgba8(c.layers[0].pixels, p.deep.PixelFormat.RGBA_U16)
        deep.data[0:4] = [12345, 23456, 34567, 45678]
        c.layers[0].deep_pixels = deep
        return c

    path, _ = saved_both(tmp_path, build, "u16.pfe")
    loaded = T.pfe.load_pfe(str(path))
    np.testing.assert_array_equal(loaded.layers[0].deep_pixels.data,
                                  J.pfe.load_pfe(str(path)).layers[0].deep_pixels.data)
    np.testing.assert_array_equal(loaded.layers[0].deep_pixels.data[0:4],
                                  [12345, 23456, 34567, 45678])


def test_dirty_region_deep_sync():
    def sync(p):
        img = p.fixtures.test_gradient(8, 8)
        deep = p.deep.DeepRgbaBuffer.from_rgba8(img, p.deep.PixelFormat.RGBA_U16)
        orig = deep.data.copy()
        edited = img.copy()
        edited[0, 0] = [10, 20, 30, 40]
        deep.sync_region_from_u8(edited, 0, 0, 1, 1)
        return deep.data, orig

    data, orig = sync(T)
    np.testing.assert_array_equal(data, sync(J)[0])
    np.testing.assert_array_equal(data[0:4], [2570, 5140, 7710, 10280])
    np.testing.assert_array_equal(data[4:8], orig[4:8])


# -- the deep export pipeline -----------------------------------------------------


def deep_canvas(p, img, fmt):
    c = p.Canvas.from_image(img)
    c.layers[0].pixel_format = p.deep.PixelFormat[fmt]
    c.layers[0].deep_pixels = p.deep.DeepRgbaBuffer.from_rgba8(img, p.deep.PixelFormat[fmt])
    return c


def prepared_both(build):
    prep = T.de.prepare_export_image(build(T), device="cpu")
    ref = J.de.prepare_export_image(build(J))
    assert (prep.kind, prep.width, prep.height) == (ref.kind, ref.width, ref.height)
    assert prep.data.dtype == ref.data.dtype
    np.testing.assert_array_equal(prep.data, ref.data)
    return prep


def test_prepare_export_single_deep_u16():
    img = np.random.default_rng(1).integers(0, 256, (12, 10, 4), np.uint8)
    prep = prepared_both(lambda p: deep_canvas(p, img, "RGBA_U16"))
    assert prep.kind == "rgba16"
    np.testing.assert_array_equal(prep.data.reshape(12, 10, 4), img.astype(np.uint16) * 257)


def test_png16_roundtrip(tmp_path):
    u16 = np.random.default_rng(2).integers(0, 65536, (9, 7, 4), np.uint16)
    T.de.write_png16(tmp_path / "x.png", 7, 9, u16)
    J.de.write_png16(tmp_path / "j.png", 7, 9, u16)
    path = tmp_path / "x.png"
    assert path.read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(T.de.read_png16(path), u16)
    preview, fmt, buf = T.de.load_deep_image(path)
    jpreview, jfmt, jbuf = J.de.load_deep_image(path)
    assert fmt.name == jfmt.name
    np.testing.assert_array_equal(preview, jpreview)
    np.testing.assert_array_equal(buf.data, jbuf.data)
    np.testing.assert_array_equal(buf.data.reshape(9, 7, 4), u16)
    np.testing.assert_array_equal(preview, ((u16.astype(np.uint32) + 128) // 257).astype(np.uint8))


@pytest.mark.parametrize("comp", ["none", "lzw", "deflate"])
def test_tiff16_roundtrip(tmp_path, comp):
    u16 = np.random.default_rng(3).integers(0, 65536, (8, 8, 4), np.uint16)
    path = tmp_path / f"x_{comp}.tiff"
    T.de.write_tiff16(path, 8, 8, u16, comp)
    J.de.write_tiff16(tmp_path / "j.tiff", 8, 8, u16, comp)
    assert path.read_bytes() == (tmp_path / "j.tiff").read_bytes()
    back = T.de.read_tiff_deep(path)
    np.testing.assert_array_equal(back, J.de.read_tiff_deep(path))
    np.testing.assert_array_equal(back, u16)
    assert Image.open(path).size == (8, 8)


def test_tiff_f32_roundtrip(tmp_path):
    f = np.random.default_rng(4).random((6, 5, 4), np.float32) * 2.0
    path = tmp_path / "x.tiff"
    T.de.write_tiff_f32(path, 5, 6, f)
    J.de.write_tiff_f32(tmp_path / "j.tiff", 5, 6, f)
    assert path.read_bytes() == (tmp_path / "j.tiff").read_bytes()
    back = T.de.read_tiff_deep(path)
    np.testing.assert_array_equal(back, J.de.read_tiff_deep(path))
    np.testing.assert_array_equal(back, f)


def test_adjusted_deep_export_applies_in_f32():
    img = np.random.default_rng(5).integers(0, 256, (8, 8, 4), np.uint8)

    def build(p):
        c = deep_canvas(p, img, "RGBA_U16")
        adj = p.Layer.new("adj", 8, 8)
        adj.content = "adjustment"
        adj.adjustment = p.deep.AdjustmentLayerData(kind=p.deep.AdjustmentKind.EXPOSURE, ev=1.0)
        c.layers.append(adj)
        return c

    prep = prepared_both(build)
    assert prep.kind == "rgba16"
    f = img.astype(np.float32) / np.float32(255.0)
    expected = f * np.array([2, 2, 2, 1], np.float32)
    expected = np.floor(np.clip(expected, 0, 1) * 65535.0 + 0.5).astype(np.uint16)
    np.testing.assert_array_equal(prep.data, expected)


def test_composite_promotion_and_rgba8_fallbacks():
    img = np.random.default_rng(6).integers(0, 256, (8, 8, 4), np.uint8)

    def build(p):
        c = p.Canvas.from_image(img)
        c.layers[0].pixel_format = p.deep.PixelFormat.RGBA_U16  # no deep buffer in sync
        return c

    prep = prepared_both(build)
    assert prep.kind == "rgba16"
    flat = build(T).composite(device="cpu")
    np.testing.assert_array_equal(prep.data, flat.astype(np.uint16) * 257)
    down = T.de.prepared_to_rgba8(prep)
    np.testing.assert_array_equal(down, flat)
    hdr_px = np.array([[[2.0, 0.5, 0.1, 1.0], [0.5, 0.5, 0.5, 1.0]]], np.float32)
    out = T.de.prepared_to_rgba8(T.de.PreparedExport("rgbaf32", 2, 1, hdr_px))
    np.testing.assert_array_equal(
        out, J.de.prepared_to_rgba8(J.de.PreparedExport("rgbaf32", 2, 1, hdr_px)))
    np.testing.assert_array_equal(out[0, 0], [170, 85, 23, 255])
    np.testing.assert_array_equal(out[0, 1], [128, 128, 128, 255])


def test_cli_deep_png_to_tiff(tmp_path):
    u16 = np.random.default_rng(7).integers(0, 65536, (8, 8, 4), np.uint16)
    src = tmp_path / "in.png"
    T.de.write_png16(src, 8, 8, u16)
    argv = ["-i", str(src), "-f", "tiff", "--tiff-compression", "lzw"]
    assert jcli.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    assert tcli.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    out = tmp_path / "t" / "in.tiff"
    assert out.read_bytes() == (tmp_path / "j" / "in.tiff").read_bytes()
    np.testing.assert_array_equal(T.de.read_tiff_deep(out), u16)


# -- native byte codecs against the plain oracles and the JAX package ----------------


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png16_adaptive_filters_native_matches_oracle(tmp_path, filters):
    rng = np.random.default_rng(sum(filters) + 11)
    u16 = rng.integers(0, 65536, (10, 13, 4), np.uint16)
    path = tmp_path / "f.png"
    _write_png16_filtered(path, u16, filters)
    np.testing.assert_array_equal(T.de.read_png16(path), u16)
    np.testing.assert_array_equal(J.de.read_png16(path), u16)
    raw = _forward_filter_png16(u16, filters)
    stride = 13 * 8
    native = T.de.png_defilter(raw, 10, stride, 8)
    assert native == T.de.png_defilter_plain(raw, 10, stride, 8)
    assert native == J.de._png_defilter_native(raw, 10, stride, 8)
    assert native == u16.astype(">u2").tobytes()


def lzw_cases():
    rng = np.random.default_rng(5)
    return [
        b"",
        b"\x00" * 5000,
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8).tolist()),
        bytes((rng.integers(0, 4, 70000, dtype=np.uint8) * 64).tolist()),
        # enough data to overflow the 12-bit table and force a mid-stream Clear
        bytes(rng.integers(0, 256, 200000, dtype=np.uint8).tolist()),
    ]


@pytest.mark.parametrize("case", range(5), ids=["empty", "run", "noise", "four_values",
                                                "table_overflow"])
def test_lzw_native_matches_plain_oracle(case):
    data = lzw_cases()[case]
    fast = T.de._lzw_encode(data)
    assert fast == T.de._lzw_encode_plain(data), f"native/plain LZW divergence on {len(data)}B"
    assert fast == J.de._lzw_encode(data)
    assert T.de._lzw_decode(fast, len(data)) == data


# -- PFE V2 (text layers) and the V3 metadata promotion ------------------------------


def text_block(p):
    t = p.text
    return t.TextBlock(
        position=(5.0, 7.0), rotation=12.5,
        runs=[t.TextRun(text="Hi", style=t.TextStyle(font_size=18.0, color=(10, 20, 30, 255),
                                                     italic=True))],
        paragraph=t.ParagraphStyle(alignment=t.TextAlignment.CENTER, line_spacing=1.5),
        max_width=120.0, warp=t.ArcWarp(bend=0.25))


def test_pfe_v2_text_layer_roundtrip(tmp_path):
    def build(p):
        t = p.text
        c = p.Canvas.from_image(p.fixtures.test_gradient(64, 64))
        tl = p.Layer.new("caption", 64, 64)
        tl.content = "text"
        td = t.TextLayerData()
        td.add_block(text_block(p))
        td.effects = t.TextEffects(
            outline=t.OutlineEffect(color=(1, 2, 3, 255), width=3.0,
                                    position=t.OutlinePosition.CENTER),
            shadow=t.ShadowEffect(offset_x=4.0, blur_radius=1.5))
        tl.text_data = td
        tl.pixels = np.asarray(td.rasterize(64, 64, **dev(p)))
        c.layers.append(tl)
        return c

    path, c = saved_both(tmp_path, build, "text.pfe")
    with open(path, "rb") as fh:
        assert fh.read(12)[8:] == b"PFE2"
    loaded = T.pfe.load_pfe(str(path))
    same_layers(loaded, J.pfe.load_pfe(str(path)))
    lt = loaded.layers[1]
    assert lt.content == "text" and lt.text_data is not None
    blk = lt.text_data.blocks[0]
    assert blk.position == (5.0, 7.0) and blk.rotation == 12.5
    assert blk.runs[0].text == "Hi"
    assert blk.runs[0].style.font_size == 18.0
    assert blk.runs[0].style.color == (10, 20, 30, 255)
    assert blk.runs[0].style.italic
    assert blk.paragraph.alignment == T.text.TextAlignment.CENTER
    assert blk.max_width == 120.0
    assert type(blk.warp).__name__ == "ArcWarp" and blk.warp.bend == 0.25
    eff = lt.text_data.effects
    assert eff.outline.position == T.text.OutlinePosition.CENTER
    assert eff.outline.width == 3.0
    assert eff.shadow.offset_x == 4.0 and eff.shadow.blur_radius == 1.5
    np.testing.assert_array_equal(lt.pixels, c.layers[1].pixels)


def test_pfe_v3_promotion_on_source_metadata(tmp_path):
    def build(p):
        c = p.Canvas.from_image(p.fixtures.test_gradient(32, 32))
        c.layers[0].source_metadata = p.deep.ImageMetadata(
            source_format="png", png_text_chunks=[("Title", "x")])
        return c

    path, _ = saved_both(tmp_path, build, "meta.pfe")
    with open(path, "rb") as fh:
        assert fh.read(12)[8:] == b"PFE3"
    loaded = T.pfe.load_pfe(str(path))
    same_layers(loaded, J.pfe.load_pfe(str(path)))
    assert loaded.layers[0].source_metadata.source_format == "png"
    assert loaded.layers[0].source_metadata.png_text_chunks == [("Title", "x")]


def test_pfe_v3_text_layer_keeps_text_data(tmp_path):
    def build(p):
        c = p.Canvas.from_image(p.fixtures.test_gradient(32, 32))
        c.layers[0].source_metadata = p.deep.ImageMetadata(source_format="png")  # force V3
        tl = p.Layer.new("t", 32, 32)
        tl.content = "text"
        td = p.text.TextLayerData()
        td.add_block(p.text.TextBlock(position=(1.0, 2.0), runs=[p.text.TextRun(text="v3")]))
        tl.text_data = td
        c.layers.append(tl)
        return c

    path, _ = saved_both(tmp_path, build, "t3.pfe")
    loaded = T.pfe.load_pfe(str(path))
    same_layers(loaded, J.pfe.load_pfe(str(path)))
    assert loaded.layers[1].content == "text"
    assert loaded.layers[1].text_data.blocks[0].runs[0].text == "v3"
