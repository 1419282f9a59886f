"""The port's 16-bit inputs (paintfe_tpu_torch.io.deep_export's read half,
native/bytecodec.cpp) against the JAX package's, and the port's CLI on
16-bit PNGs and TIFFs against the JAX CLI.  Inputs are made from seeds with
numpy; tolerance 0 (bytes) throughout."""

import struct

import numpy as np
import pytest

import chip_smoke
from paintfe_tpu import cli as jcli
from paintfe_tpu.io import deep_export as jdeep
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch import native
from paintfe_tpu_torch.io import deep_export as tdeep


def _u16(seed, h, w, ch):
    """Smooth ramps plus noise: runs the LZW encoder's dictionary grows on,
    and rows every PNG filter predicts differently."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx[..., None] * 977 + yy[..., None] * 331 + np.arange(ch) * 5000) % 65536
    return ((base + rng.integers(0, 900, (h, w, ch))) % 65536).astype(np.uint16)


@pytest.mark.parametrize("ch", [3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 2, 3, 1)])
def test_read_png16_matches_jax(tmp_path, ch, filters):
    px = _u16(len(filters) * 10 + ch, 23, 37, ch)
    path = tmp_path / "in.png"
    path.write_bytes(chip_smoke.png16_bytes(px, filters))
    got = tdeep.read_png16(path)
    np.testing.assert_array_equal(got, jdeep.read_png16(path))
    np.testing.assert_array_equal(got[..., :ch], px)  # tolerance 0
    assert got.dtype == np.uint16 and got.shape == (23, 37, 4)


def test_read_png16_refuses_interlaced(tmp_path):
    blob = bytearray(chip_smoke.png16_bytes(_u16(1, 4, 4, 4)))
    blob[8 + 8 + 12] = 1  # IHDR interlace method: Adam7
    (tmp_path / "i.png").write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="Adam7"):
        tdeep.read_png16(tmp_path / "i.png")
    assert tdeep.load_deep_image(tmp_path / "i.png") is None


@pytest.mark.parametrize("bpp", [1, 3, 6, 8])
def test_native_defilter_matches_plain(bpp):
    """Random rows of every filter type through the C++ and the pure
    loop: the same bytes."""
    rng = np.random.default_rng(bpp)
    h, stride = 40, bpp * 29
    raw = rng.integers(0, 256, (h, stride + 1), np.uint8)
    raw[:, 0] = np.arange(h) % 5
    raw = raw.tobytes()
    assert tdeep.png_defilter(raw, h, stride, bpp) == tdeep.png_defilter_plain(raw, h, stride, bpp)


def test_native_defilter_takes_the_plain_loop_on_unknown_filters():
    raw = bytes([7]) + bytes(range(16)) + bytes([1]) + bytes(range(16))
    assert tdeep.png_defilter(raw, 2, 16, 4) == tdeep.png_defilter_plain(raw, 2, 16, 4)


def _code_boundary_inputs():
    """Data whose LZW dictionaries cross each code-width boundary (9->10,
    10->11, 11->12 bits) and the table reset at 4096 entries."""
    rng = np.random.default_rng(5)
    out = {"empty": b"", "one": b"\x07", "zeros": bytes(70000)}
    for n in (250, 251, 252, 253, 254, 255, 256, 257, 258, 510, 766, 767, 768, 769,
              1790, 1791, 1792, 1793, 3838, 3839, 3840, 3841, 3842, 20000):
        out[f"random{n}"] = rng.integers(0, 256, n, np.uint8).tobytes()
    out["ramp"] = (np.arange(40000) % 251).astype(np.uint8).tobytes()
    return out


@pytest.mark.parametrize("name", sorted(_code_boundary_inputs()))
def test_native_lzw_matches_plain_and_jax(name):
    data = _code_boundary_inputs()[name]
    enc = tdeep._lzw_encode(data)
    assert enc == tdeep._lzw_encode_plain(data)
    assert enc == jdeep._lzw_encode(data)
    assert tdeep._lzw_decode(enc, len(data)) == data


def test_lzw_decode_stops_at_the_strip_size():
    """The early-change boundary: the stream's last data code brings the
    table to 2^width - 1 entries, so its EOI is written at the old width;
    an unbounded decode reads it as data, the strip size stops it."""
    rng = np.random.default_rng(9)
    hits = 0
    for _ in range(300):  # about 766 codes: the 10 -> 11 bit boundary
        data = rng.integers(0, 256, int(rng.integers(766, 800)), np.uint8).tobytes()
        enc = tdeep._lzw_encode(data)
        bounded = tdeep._lzw_decode(enc, len(data))
        assert bounded == data == jdeep._lzw_decode(enc, len(data))
        unbounded = tdeep._lzw_decode(enc)
        assert unbounded == jdeep._lzw_decode(enc)
        hits += unbounded != data
    assert hits  # the boundary case occurred in the sweep


def test_native_library_builds_into_the_build_directory():
    lib = native.load()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "build"
    assert lib.png_defilter is not None and lib.tiff_lzw_encode is not None


def test_a_failed_native_build_raises_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "bytecodec.cpp"
    bad.write_text('extern "C" int png_defilter( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.load.__wrapped__()
    assert "bytecodec.cpp" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so*"))


@pytest.mark.parametrize("kind,compression", [("u16", "none"), ("u16", "lzw"),
                                              ("u16", "deflate"), ("f32", "none")])
def test_read_tiff_deep_and_load_deep_image_match_jax(tmp_path, kind, compression):
    path = tmp_path / "in.tif"
    if kind == "u16":
        px = _u16(3, 19, 29, 4)
        jdeep.write_tiff16(path, 29, 19, px, compression)
    else:
        px = np.random.default_rng(4).uniform(-0.2, 1.7, (19, 29, 4)).astype(np.float32)
        jdeep.write_tiff_f32(path, 29, 19, px)
    got = tdeep.read_tiff_deep(path)
    np.testing.assert_array_equal(got, jdeep.read_tiff_deep(path))
    np.testing.assert_array_equal(got, px)
    tp, tfmt, tbuf = tdeep.load_deep_image(path)
    jp, jfmt, jbuf = jdeep.load_deep_image(path)
    np.testing.assert_array_equal(tp, jp)
    assert tfmt.value == jfmt.value
    np.testing.assert_array_equal(tbuf.data, jbuf.data)


def _tiff_rgb16_big_endian(path, px):
    """A big-endian, uncompressed, three-sample 16-bit TIFF written by hand."""
    h, w, _ = px.shape
    payload = np.ascontiguousarray(px, ">u2").tobytes()
    tags = [(256, 4, 1, struct.pack(">I", w)), (257, 4, 1, struct.pack(">I", h)),
            (258, 3, 3, struct.pack(">I", 8 + 2 + 9 * 12 + 4)), (259, 3, 1, b"\0\x01\0\0"),
            (262, 3, 1, b"\0\x02\0\0"), (273, 4, 1, struct.pack(">I", 8 + 2 + 9 * 12 + 4 + 6)),
            (277, 3, 1, b"\0\x03\0\0"), (278, 4, 1, struct.pack(">I", h)),
            (279, 4, 1, struct.pack(">I", len(payload)))]
    blob = b"MM\0*" + struct.pack(">I", 8) + struct.pack(">H", len(tags))
    blob += b"".join(struct.pack(">HHI", t, ty, n) + v for t, ty, n, v in tags)
    blob += struct.pack(">I", 0) + struct.pack(">HHH", 16, 16, 16) + payload
    path.write_bytes(blob)


def test_big_endian_rgb_tiff_matches_jax(tmp_path):
    px = _u16(6, 11, 13, 3)
    _tiff_rgb16_big_endian(tmp_path / "be.tif", px)
    got = tdeep.read_tiff_deep(tmp_path / "be.tif")
    np.testing.assert_array_equal(got, jdeep.read_tiff_deep(tmp_path / "be.tif"))
    np.testing.assert_array_equal(got[..., :3], px)
    assert (got[..., 3] == 65535).all()


def test_eight_bit_files_are_not_deep(tmp_path):
    from PIL import Image

    Image.fromarray(np.zeros((4, 4, 4), np.uint8), "RGBA").save(tmp_path / "a.png")
    Image.fromarray(np.zeros((4, 4, 4), np.uint8), "RGBA").save(tmp_path / "a.tif")
    (tmp_path / "junk.tif").write_bytes(b"not a tiff")
    for name in ("a.png", "a.tif", "junk.tif"):
        assert tdeep.load_deep_image(tmp_path / name) is None
        assert jdeep.load_deep_image(tmp_path / name) is None


def _deep_inputs(d):
    rng = np.random.default_rng(12)
    px = _u16(21, 30, 44, 4)
    px[:6, :, 3] = 0  # a transparent band
    (d / "deep.png").write_bytes(chip_smoke.png16_bytes(px))
    jdeep.write_tiff16(d / "deflate.tif", 44, 30, _u16(22, 30, 44, 4), "deflate")
    jdeep.write_tiff16(d / "lzw.tif", 31, 17, _u16(23, 17, 31, 4), "lzw")
    jdeep.write_tiff_f32(d / "float.tif", 31, 17,
                         rng.uniform(0.0, 1.0, (17, 31, 4)).astype(np.float32))
    return ["deep.png", "deflate.tif", "lzw.tif", "float.tif"]


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("fmt,compression", [("png", "none"), ("tiff", "none"),
                                             ("tiff", "lzw")])
@pytest.mark.parametrize("script", ["apply_blur(2.0);", None])
def test_cli_on_deep_inputs_matches_jax_cli(tmp_path, shard, fmt, compression, script):
    """16-bit PNG and 16/32-bit TIFF inputs through both CLIs: the output
    files' bytes are equal (a 16-bit output where the deep payload
    survives, serially; --shard reads the inputs through the u8 codec in
    both packages)."""
    names = _deep_inputs(tmp_path)
    common = ["-i", *[str(tmp_path / n) for n in names], "-f", fmt,
              "--tiff-compression", compression]
    if script is not None:
        (tmp_path / "fx.rhai").write_text(script)
        common += ["-s", str(tmp_path / "fx.rhai")]
    extra = ["--shard"] if shard else []
    jrc = jcli.main(common + ["--output-dir", str(tmp_path / "jax"), *extra])
    trc = tcli.main(common + ["--output-dir", str(tmp_path / "port"), "--device", "cpu",
                              *extra])
    assert trc == jrc
    ref = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ref
    assert ref  # something was written
    for name in ref:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_cli_deep_input_with_a_resizing_script_matches_jax_cli(tmp_path):
    """A 16-bit input whose script resizes it: the deep buffer is rebuilt
    from the new u8 result (a stale one of the old size crashed the
    export)."""
    (tmp_path / "deep.png").write_bytes(chip_smoke.png16_bytes(_u16(31, 24, 40, 4)))
    (tmp_path / "fx.rhai").write_text('resize_image(17, 13, "bilinear"); apply_invert();')
    common = ["-i", str(tmp_path / "deep.png"), "-s", str(tmp_path / "fx.rhai"),
              "-f", "png"]
    assert jcli.main(common + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert tcli.main(common + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = (tmp_path / "port" / "deep.png").read_bytes()
    assert got == (tmp_path / "jax" / "deep.png").read_bytes()
    assert tdeep.read_png16(tmp_path / "port" / "deep.png").shape == (13, 17, 4)
