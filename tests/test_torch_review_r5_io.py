"""The port's I/O and core on the cases of tests/test_review_r5_io.py: the
TIFF LZW early-change tail (io.deep_export's native and plain codecs),
Adam7 16-bit PNGs, corrupt .pfe enum tags, planar and mixed-depth foreign
TIFFs, the 256-Mpix import clamp (core.canvas.MAX_PIXELS) and settings
validation.  Each written file equals the JAX package's byte for byte,
each reader gives the JAX package's result or error."""

import dataclasses
import struct
import zlib

import numpy as np
import pytest

from paintfe_tpu.io import deep_export as jde
from paintfe_tpu_torch.io import deep_export as tde

from test_review_r5_io import _boundary_payloads


@pytest.mark.parametrize("case", range(5))
def test_lzw_early_change_tail_roundtrip(case):
    payload = _boundary_payloads()[case]
    enc = tde._lzw_encode(payload)
    assert enc == tde._lzw_encode_plain(payload) == jde._lzw_encode(payload)
    dec = tde._lzw_decode(enc, len(payload))
    assert dec == tde._lzw_decode_plain(enc, len(payload)) == jde._lzw_decode(enc, len(payload))
    assert dec == payload
    free = tde._lzw_decode(enc)
    assert free == jde._lzw_decode(enc)
    assert free[:len(payload)] == payload


def test_tiff_lzw_roundtrip_at_boundary(tmp_path):
    rng = np.random.default_rng(911)
    for _ in range(6):
        h, w = int(rng.integers(5, 40)), int(rng.integers(5, 40))
        px = rng.integers(0, 65536, (h, w, 4)).astype(np.uint16)
        p = tmp_path / "t.tiff"
        tde.write_tiff16(p, w, h, px, compression="lzw")
        jde.write_tiff16(tmp_path / "j.tiff", w, h, px, compression="lzw")
        assert p.read_bytes() == (tmp_path / "j.tiff").read_bytes()
        back = tde.read_tiff_deep(p)
        assert back.dtype == np.uint16
        np.testing.assert_array_equal(back, px)


def test_interlaced_png16_rejected(tmp_path):
    w = h = 8
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 6, 0, 0, 1)  # interlace=1
    raw = bytes((h * (w * 8 + 1)) + 64)

    def chunk(tag, payload):
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", zlib.crc32(tag + payload))

    p = tmp_path / "i.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                  + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    for de in (tde, jde):
        with pytest.raises(ValueError, match="interlaced"):
            de.read_png16(p)
        assert de.load_deep_image(p) is None


def test_corrupt_pfe_enum_tags_raise_pfe_error(tmp_path):
    from paintfe_tpu.core.canvas import Canvas as JCanvas
    from paintfe_tpu.core.deep import DeepRgbaBuffer as JDeep, PixelFormat as JFormat
    from paintfe_tpu.io import pfe as jpfe
    from paintfe_tpu_torch.core.canvas import Canvas
    from paintfe_tpu_torch.core.deep import DeepRgbaBuffer, PixelFormat
    from paintfe_tpu_torch.io import pfe

    def saved(canvas_cls, deep_cls, fmt, save, path):
        c = canvas_cls.new(4, 4, (10, 20, 30, 255))
        c.layers[0].pixel_format = fmt.RGBA_U16
        c.layers[0].deep_pixels = deep_cls(fmt.RGBA_U16, np.zeros(4 * 4 * 4, np.uint16))
        save(c, path)
        return path.read_bytes()

    blob = bytearray(saved(Canvas, DeepRgbaBuffer, PixelFormat, pfe.save_pfe, tmp_path / "x.pfe"))
    assert bytes(blob) == saved(JCanvas, JDeep, JFormat, jpfe.save_pfe, tmp_path / "j.pfe")
    # the deep-buffer record is [fmt tag u32 = 1 (RGBA_U16)][count u64 = 64]
    sig = struct.pack("<I", 1) + struct.pack("<Q", 4 * 4 * 4)
    idx = bytes(blob).find(sig, 8)
    assert idx != -1
    blob[idx:idx + 4] = struct.pack("<I", 99)
    (tmp_path / "x.pfe").write_bytes(bytes(blob))
    with pytest.raises(pfe.PfeError) as ei:
        pfe.load_pfe(str(tmp_path / "x.pfe"))
    with pytest.raises(jpfe.PfeError) as ej:
        jpfe.load_pfe(str(tmp_path / "x.pfe"))
    assert str(ei.value) == str(ej.value)


def write_min_tiff(path, extra_tags):
    """A 4x4 16-bit RGBA TIFF with one strip and `extra_tags` over the base
    tags: tag -> (type 3 SHORT or 4 LONG, values)."""
    w = h = 4
    payload = np.zeros(h * w * 4, "<u2").tobytes()
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [16, 16, 16, 16]),
            259: (3, [1]), 277: (3, [4]), 278: (3, [h]), 279: (4, [len(payload)])}
    tags.update(extra_tags)
    n = len(tags) + 1  # + strip offset tag
    data_start = 8 + 2 + (n * 12) + 4
    extra = bytearray()
    entries = []
    for tag in sorted(tags):
        typ, vals = tags[tag]
        fmt = {3: "H", 4: "I"}[typ]
        enc = struct.pack(f"<{len(vals)}{fmt}", *vals)
        if len(enc) <= 4:
            entries.append((tag, typ, len(vals), enc.ljust(4, b"\0")))
        else:
            entries.append((tag, typ, len(vals), struct.pack("<I", data_start + len(extra))))
            extra += enc
    entries.append((273, 4, 1, struct.pack("<I", data_start + len(extra))))
    out = b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", n)
    for tag, typ, cnt, val in sorted(entries):
        out += struct.pack("<HHI", tag, typ, cnt) + val
    path.write_bytes(out + struct.pack("<I", 0) + bytes(extra) + payload)


@pytest.mark.parametrize("extra,needle", [
    ({284: (3, [2])}, "planar"),
    ({258: (3, [16, 16, 16, 8])}, "mixed"),
], ids=["planar", "mixed_depth"])
def test_planar_and_mixed_depth_tiffs_rejected(tmp_path, extra, needle):
    p = tmp_path / "foreign.tiff"
    write_min_tiff(p, extra)
    with pytest.raises(ValueError, match=needle) as ei:
        tde.read_tiff_deep(p)
    with pytest.raises(ValueError, match=needle) as ej:
        jde.read_tiff_deep(p)
    assert str(ei.value) == str(ej.value)


def test_from_image_clamps_oversized(monkeypatch, capsys):
    """Each package with its own MAX_PIXELS lowered to 5000."""
    import paintfe_tpu.core.canvas as jcanvas
    import paintfe_tpu_torch.core.canvas as tcanvas

    img = np.zeros((100, 100, 4), np.uint8)
    out = []
    for mod in (tcanvas, jcanvas):
        monkeypatch.setattr(mod, "MAX_PIXELS", 5000)
        c = mod.Canvas.from_image(img)
        out.append(((c.width, c.height), capsys.readouterr().err))
    assert out[0] == out[1]
    assert out[0][0] == (1, 1)
    assert "clamped" in out[0][1]


def test_settings_shape_validation(tmp_path):
    from paintfe_tpu.utils.settings import AppSettings as JSettings
    from paintfe_tpu_torch.utils.settings import AppSettings

    p = tmp_path / "settings.json"
    p.write_text('{"default_background": [255, 255, 255], '
                 '"max_recent_files": 2.5, "autosave_interval_minutes": 7}')
    s = AppSettings.load(p)
    assert dataclasses.asdict(s) == dataclasses.asdict(JSettings.load(p))
    d = AppSettings()
    assert s.default_background == d.default_background
    assert s.max_recent_files == d.max_recent_files
    assert s.autosave_interval_minutes == 7
