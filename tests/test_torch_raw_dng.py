"""The port's DNG ingestion (paintfe_tpu_torch.io.raw, develop stage on the
CPU) against the JAX package's, at tolerance 0.

Each case writes its files with the JAX tests' own writers
(tests/test_raw_dng.py) and decodes every file through both packages: the
same RGBA bytes, or the same error class and message.  Fuzzed files must
agree on the outcome: equal bytes, or an error of the same class in both
(RawError/CodecError, or what the JAX package itself lets through).  The cases
mirror tests/test_raw_dng.py one by one; its decoder-stream tests
(lossless-JPEG restarts, baseline-DCT streams) are mirrored in
tests/test_torch_native.py.
"""

import struct

import numpy as np
import pytest

from paintfe_tpu.io import codecs as jcodecs
from paintfe_tpu.io import raw as jraw
from paintfe_tpu_torch.io import codecs as tcodecs
from paintfe_tpu_torch.io import raw as traw
from tests.ljpeg_writer import encode_ljpeg
from tests.test_raw_dng import _fp_fixture, _pil_jpeg, _write_multistrip_dng, write_dng


def decode_outcome(load, path, **kw):
    """("ok", RGBA u8) or ("error", class name, message): RawError or
    CodecError, or whatever else the JAX package lets through on a fuzzed
    file, which the port must let through too."""
    try:
        return ("ok", load(path, **kw))
    except Exception as e:  # noqa: BLE001 - the class is compared
        return ("error", type(e).__name__, str(e))


def assert_same_decode(path, jload=jcodecs.load_image, tload=tcodecs.load_image,
                       messages=True):
    """Both packages give the same bytes for `path`, or the same error
    (class, and message unless `messages` is false); returns the JAX
    outcome."""
    want = decode_outcome(jload, path)
    got = decode_outcome(tload, path, device="cpu")
    assert got[0] == want[0], (path.name, got[:1] + got[2:], want[:1] + want[2:])
    if want[0] == "ok":
        assert got[1].dtype == np.uint8 and got[1].shape == want[1].shape
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] == want[1]
        if messages:
            assert got[2] == want[2]
    return want


def assert_fuzz_agrees(base: bytes, path, rng, trials, jload, tload, min_len=4):
    """Byte mutations (and truncations) of `base`: both packages decode to
    equal bytes or both raise."""
    outcomes = {"ok": 0, "error": 0}
    for _ in range(trials):
        blob = bytearray(base)
        for _ in range(rng.integers(1, 8)):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            blob = blob[: int(rng.integers(min_len, len(blob)))]
        path.write_bytes(bytes(blob))
        outcomes[assert_same_decode(path, jload, tload, messages=False)[0]] += 1
    return outcomes


CFA = [(33421, 3, 2, [2, 2]), (33422, 1, 4, [0, 1, 1, 2])]


def _linear_rgb(d):
    rng = np.random.default_rng(0)
    write_dng(d / "lin.dng", rng.integers(0, 65536, (12, 17, 3)).astype(np.uint16),
              photometric=34892)


def _gray_levels(d):
    write_dng(d / "gray.dng", np.full((6, 8), 2000, np.uint16), photometric=1,
              black=1000, white=3000)


def _cfa_constant(d):
    write_dng(d / "cfa.dng", np.full((16, 24), 30000, np.uint16), photometric=32803,
              extra_tags=CFA + [(50728, 5, 3, [(1, 1), (1, 1), (1, 1)])])


def _cfa_white_balance(d):
    write_dng(d / "wb.dng", np.full((12, 12), 10000, np.uint16), photometric=32803,
              extra_tags=CFA + [(50728, 5, 3, [(1, 2), (1, 1), (4, 5)])])


def _ljpeg_vs_plain(d):
    mosaic = np.random.default_rng(7).integers(0, 1 << 16, (18, 26)).astype(np.uint16)
    extra = CFA + [(50728, 5, 3, [(1, 2), (1, 1), (2, 3)])]
    write_dng(d / "plain.dng", mosaic, photometric=32803, extra_tags=extra)
    write_dng(d / "lj.dng", mosaic, photometric=32803, extra_tags=extra, compression=7)


def _ljpeg_multi_strip(d):
    lin = np.random.default_rng(8).integers(0, 1 << 16, (12, 10, 3)).astype(np.uint16)
    strips = [encode_ljpeg(lin[y:y + 4].reshape(4, 15, 2), 16) for y in (0, 4, 8)]
    _write_multistrip_dng(d / "strips.dng", strips, w=10, h=12, spp=3, rows_per_strip=4)


def _per_plane_black(d):
    blacks = np.array([[100, 200], [300, 400]], np.uint16)
    ys, xs = np.mgrid[0:8, 0:8]
    write_dng(d / "pb.dng", (blacks[ys % 2, xs % 2] + 10000).astype(np.uint16),
              photometric=32803, white=30000,
              extra_tags=[(33421, 3, 2, [2, 2]), (33422, 1, 4, [1, 0, 2, 1]),
                          (50713, 3, 2, [2, 2]), (50714, 3, 4, [100, 200, 300, 400])])


def _mismatched_black_repeat(d):
    write_dng(d / "bad.dng", np.full((8, 8), 500, np.uint16), photometric=32803,
              extra_tags=CFA + [(50714, 3, 4, [1, 2, 3, 4])])


def _active_area(d):
    full = np.zeros((20, 24), np.uint16)
    full[3:19, 4:22] = np.random.default_rng(11).integers(5000, 60000, (16, 18))
    write_dng(d / "aa.dng", full, photometric=32803,
              extra_tags=CFA + [(50829, 3, 4, [3, 4, 19, 22])])


def _color_matrix(d):
    lin = np.random.default_rng(12).integers(0, 1 << 16, (10, 14, 3)).astype(np.uint16)
    m = np.linalg.inv(np.array([[0.4124564, 0.3575761, 0.1804375],
                                [0.2126729, 0.7151522, 0.0721750],
                                [0.0193339, 0.1191920, 0.9503041]]))
    write_dng(d / "matrix.dng", lin, photometric=34892,
              extra_tags=[(50721, 10, 9, [(int(round(v * 10000)), 10000) for v in m.flat])])
    m[:, 0] *= 2.0
    write_dng(d / "matrix2.dng", lin, photometric=34892,
              extra_tags=[(50721, 10, 9, [(int(round(v * 10000)), 10000) for v in m.flat])])


def _unsupported(d):
    write_dng(d / "comp.dng", np.zeros((4, 4, 3), np.uint16), photometric=34892)
    blob = bytearray((d / "comp.dng").read_bytes())
    idx = blob.find(struct.pack("<HHI", 259, 3, 1))
    for comp, name in ((99, "unknown"), (8, "baddeflate"), (7, "badljpeg")):
        blob[idx + 8] = comp
        (d / f"{name}.dng").write_bytes(bytes(blob))
    (d / "x.cr3").write_bytes(b"\0\0\0\x18ftypcrx ")
    (d / "x.arw").write_bytes(b"II*\0")


def _malformed(d):
    write_dng(d / "ok.dng", np.zeros((4, 4, 3), np.uint16), photometric=34892)
    (d / "trunc.dng").write_bytes((d / "ok.dng").read_bytes()[:16])
    (d / "garbage.dng").write_bytes(b"II*\0" + b"\xff" * 64)


def _fp_linear_rgb(d):
    write_dng(d / "fprgb.dng", _fp_fixture(32, (7, 11, 3), seed=3), photometric=34892,
              fp_bits=32, predictor=3, compression=8)


def _fp_tiled_lzw(d):
    write_dng(d / "fptile.dng", _fp_fixture(16, (10, 13), seed=4), photometric=1, fp_bits=16,
              predictor=3, compression=5, tile=(8, 4))


def _fp_cfa_x2(d):
    write_dng(d / "fpcfa.dng", np.full((12, 16), np.float32(0.25)), photometric=32803,
              fp_bits=32, predictor=34894, compression=8,
              extra_tags=CFA + [(50728, 5, 3, [(1, 1), (1, 1), (1, 1)])])


def _fp_white_level(d):
    write_dng(d / "fpwhite.dng", np.full((5, 6), np.float32(1.0)), photometric=1, fp_bits=32,
              predictor=3, compression=8, white=4)


def _fp_unsupported_bits(d):
    write_dng(d / "fpbad.dng", _fp_fixture(32, (4, 4), seed=5), photometric=1, fp_bits=32,
              predictor=3, compression=8)
    blob = bytearray((d / "fpbad.dng").read_bytes())
    i = blob.find(bytes.fromhex("0201") + b"\x03\x00")
    blob[i + 8:i + 10] = (64).to_bytes(2, "little")
    (d / "fpbad2.dng").write_bytes(bytes(blob))


def _fp_special_values(d):
    """fp32 samples that are subnormal, NaN and +-inf, plain and on a CFA:
    no flush to zero, NaN and the infinities through the same host steps."""
    rng = np.random.default_rng(6)
    vals = rng.random((9, 12), dtype=np.float32)
    vals[0, :6] = [1e-40, -1e-42, np.nan, np.inf, -np.inf, 1.2e-38]
    vals[4, 3:7] = np.float32(2.0 ** -140)
    write_dng(d / "fpspecial.dng", vals, photometric=1, fp_bits=32, predictor=3, compression=8)
    write_dng(d / "fpspecial_cfa.dng", vals, photometric=32803, fp_bits=32, compression=1,
              extra_tags=CFA)


def _lossy_gray(d):
    x = np.linspace(0, 2 * np.pi, 48)
    img = ((np.sin(x)[None, :] * np.cos(x * 0.7)[:, None]) * 90 + 128).astype(np.uint8)
    write_dng(d / "lossy.dng", img, photometric=1, bits=8, compression=34892)
    decoded = jraw.jpegdct_decode(_pil_jpeg(img, "L", quality=95, subsampling=0))
    write_dng(d / "plain.dng", decoded, photometric=1, bits=8)


def _lossy_3ch_tiled(d):
    base = np.random.default_rng(5).integers(60, 196, (24, 32, 3)).astype(np.uint8)
    write_dng(d / "lossy3.dng", base, photometric=34892, bits=8, compression=34892,
              tile=(16, 8))


def _per_sample_black(d):
    write_dng(d / "ps.dng", np.full((8, 8, 3), 4095, np.uint16), photometric=34892,
              extra_tags=[(50714, 3, 3, [256, 0, 0])], white=4095)


def _tiled(compression):
    def make(d):
        mosaic = np.random.default_rng(9).integers(0, 1 << 16, (22, 30)).astype(np.uint16)
        write_dng(d / "strip.dng", mosaic, photometric=32803, extra_tags=CFA)
        write_dng(d / "tiled.dng", mosaic, photometric=32803, extra_tags=CFA,
                  compression=compression, tile=(16, 8))
    return make


def _lzw_deflate(compression, predictor, tiled):
    def make(d):
        rng = np.random.default_rng(31 + compression + predictor)
        mosaic = rng.integers(0, 1 << 16, (20, 28)).astype(np.uint16)
        write_dng(d / "comp.dng", mosaic, photometric=32803, extra_tags=CFA,
                  compression=compression, predictor=predictor,
                  tile=(16, 8) if tiled else None)
    return make


def _deflate_linear(d):
    lin = np.random.default_rng(17).integers(0, 1 << 16, (10, 14, 3)).astype(np.uint16)
    write_dng(d / "z.dng", lin, photometric=34892, compression=8, predictor=2)


def _fp_gray(bits, predictor, compression):
    def make(d):
        write_dng(d / "fp.dng", _fp_fixture(bits, (9, 14), seed=bits + predictor),
                  photometric=1, fp_bits=bits, predictor=predictor, compression=compression)
    return make


CASES = {
    "linear_rgb": _linear_rgb, "gray_black_white": _gray_levels,
    "cfa_constant": _cfa_constant, "cfa_white_balance": _cfa_white_balance,
    "ljpeg_vs_plain": _ljpeg_vs_plain, "ljpeg_multi_strip": _ljpeg_multi_strip,
    "tiled_plain": _tiled(1), "tiled_ljpeg": _tiled(7),
    "deflate_linear_rgb": _deflate_linear, "per_plane_black": _per_plane_black,
    "mismatched_black_repeat": _mismatched_black_repeat, "active_area": _active_area,
    "color_matrix": _color_matrix, "unsupported_paths": _unsupported,
    "malformed": _malformed, "fp_linear_rgb_deflate_pred3": _fp_linear_rgb,
    "fp_tiled_lzw": _fp_tiled_lzw, "fp_cfa_x2_predictor": _fp_cfa_x2,
    "fp_white_level": _fp_white_level, "fp_unsupported_bits": _fp_unsupported_bits,
    "fp_special_values": _fp_special_values, "lossy_gray": _lossy_gray,
    "lossy_3ch_tiled": _lossy_3ch_tiled, "per_sample_black": _per_sample_black,
}
CASES.update({f"lzw_deflate_c{c}_p{p}_{'tiles' if t else 'strips'}": _lzw_deflate(c, p, t)
              for c in (5, 8) for p in (1, 2) for t in (False, True)})
CASES.update({f"fp_gray_{b}bit_p{p}_c{c}": _fp_gray(b, p, c)
              for b in (16, 24, 32) for p in (1, 3, 34894) for c in (1, 8)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_dng_decodes_like_the_jax_package(tmp_path, case):
    """Every file of the case: load_image (extension dispatch, RawError
    wrapped in CodecError) and load_dng itself give the JAX package's
    bytes or its error."""
    CASES[case](tmp_path)
    for path in sorted(tmp_path.iterdir()):
        assert_same_decode(path)
        if path.suffix == ".dng":
            assert_same_decode(path, jraw.load_dng, traw.load_dng)


@pytest.mark.parametrize("compression", [1, 7])
def test_dng_fuzz_agrees_with_the_jax_package(tmp_path, compression):
    """Random mutations of a valid DNG (a linear RGB one, and a
    lossless-JPEG CFA one that drives the native decoder's error paths):
    both packages decode to equal bytes or both raise RawError."""
    rng = np.random.default_rng(99 + compression)
    if compression == 1:
        write_dng(tmp_path / "base.dng", rng.integers(0, 65536, (6, 9, 3)).astype(np.uint16),
                  photometric=34892)
    else:
        write_dng(tmp_path / "base.dng", rng.integers(0, 1 << 16, (10, 12)).astype(np.uint16),
                  photometric=32803, compression=7, extra_tags=CFA)
    outcomes = assert_fuzz_agrees((tmp_path / "base.dng").read_bytes(), tmp_path / "fuzz.dng",
                                  rng, 80, jraw.load_dng, traw.load_dng)
    assert outcomes["ok"] and outcomes["error"]


def test_fp24_bits_match_the_jax_package():
    """Every sign/exponent/mantissa class of fp24, the hand-built special
    values of the JAX test included, converts to the same f32 bits."""
    cases = np.array([0x000000, 0x800000, 0x3F8000, 0x3F0000, 0xBF0000, 0x400000,
                      0x3E0000, 0x7F0000, 0xFF0000, 0x000001, 0x7F1234, 0x80FFFF],
                     np.uint32)
    rand = np.random.default_rng(4).integers(0, 1 << 24, 4096).astype(np.uint32)
    for u in (cases, rand):
        np.testing.assert_array_equal(traw._fp24_bits_to_f32(u).view(np.uint32),
                                      jraw._fp24_bits_to_f32(u).view(np.uint32))


def test_a_tiff_without_dngversion_is_refused_like_the_jax_package(tmp_path):
    import PIL.Image

    PIL.Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "plain.tiff",
                                                            format="TIFF")
    with pytest.raises(traw.RawError, match="DNGVersion"):
        traw.load_dng(tmp_path / "plain.tiff", device="cpu")
    assert_same_decode(tmp_path / "plain.tiff", jraw.load_dng, traw.load_dng)


def test_raw_loaders_default_to_the_card(tmp_path):
    """load_dng and load_image of a RAW file run on the card unless the
    caller asks for the CPU: without one they raise, never a silent CPU
    run; a PNG through load_image never asks for the card."""
    import torch

    write_dng(tmp_path / "g.dng", np.full((4, 6), 900, np.uint16), photometric=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traw.load_dng(tmp_path / "g.dng")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcodecs.load_image(tmp_path / "g.dng")
    import PIL.Image

    PIL.Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(tmp_path / "x.png")
    assert tcodecs.load_image(tmp_path / "x.png").shape == (4, 4, 4)
