"""The port's C++ (paintfe_tpu_torch/native) against its plain versions and
the JAX package: the lossless-JPEG and baseline-DCT decoders (the decoder
tests of tests/test_raw_dng.py, mirrored), the TIFF LZW decode against the
pure decoder, and NeuQuant against the port's numpy trainer and the JAX
package's quantize_rgba."""

import ctypes
import io

import numpy as np
import pytest
from PIL import Image

from paintfe_tpu.io import deep_export as jdeep
from paintfe_tpu.io import neuquant as jneuquant
from paintfe_tpu.io import raw as jraw
from paintfe_tpu_torch import native
from paintfe_tpu_torch.io import deep_export as tdeep
from paintfe_tpu_torch.io import neuquant as tneuquant
from paintfe_tpu_torch.io import raw as traw
from tests.ljpeg_writer import encode_ljpeg


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the class and message are compared
        return ("error", type(e).__name__, str(e))


def _assert_same(got, want):
    assert got[0] == want[0], (got[:1] + got[2:], want[:1] + want[2:])
    if want[0] == "ok":
        assert got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1:] == want[1:]


def test_the_library_holds_every_entry_point():
    lib = native.load()
    assert native.library_path().exists() and native.library_path().parent.name == "build"
    assert [s.name for s in native.SOURCES] == ["bytecodec.cpp", "ljpeg.cpp", "jpegdct.cpp",
                                                "neuquant.cpp", "inpaint.cpp"]
    for name in ("png_defilter", "tiff_lzw_encode", "tiff_lzw_decode", "pfe_free",
                 "ljpeg_info", "ljpeg_decode", "jpegdct_info", "jpegdct_decode",
                 "neuquant_quantize", "patchmatch_fill", "inpaint_instant_brush"):
        assert getattr(lib, name).argtypes


# -- lossless JPEG (SOF3) -----------------------------------------------------

@pytest.mark.parametrize("predictor", [1, 4, 7])
def test_ljpeg_restart_intervals_match_the_jax_decoder(predictor):
    """Row-aligned restart markers decode like the restart-free stream, in
    both packages."""
    samples = np.random.default_rng(9).integers(0, 1 << 14, (11, 8)).astype(np.uint16)
    for stream in (encode_ljpeg(samples, 14, predictor=predictor),
                   encode_ljpeg(samples, 14, predictor=predictor, restart_rows=3)):
        got, prec = traw.ljpeg_decode_full(stream)
        want, want_prec = jraw.ljpeg_decode_full(stream)
        assert prec == want_prec == 14
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, samples)


def test_ljpeg_midrow_restart_is_rejected_like_the_jax_decoder():
    samples = np.random.default_rng(10).integers(0, 1 << 12, (8, 6)).astype(np.uint16)
    stream = bytearray(encode_ljpeg(samples, 12, restart_rows=2))
    i = stream.find(b"\xff\xdd")
    stream[i + 4:i + 6] = (7).to_bytes(2, "big")  # 7 % 6 != 0
    with pytest.raises(traw.RawError, match="mid-row restart"):
        traw.ljpeg_decode(bytes(stream))
    _assert_same(_outcome(traw.ljpeg_decode, bytes(stream)),
                 _outcome(jraw.ljpeg_decode, bytes(stream)))


@pytest.mark.parametrize("precision,components,pt", [(16, 1, 0), (12, 2, 0), (14, 3, 2),
                                                     (8, 4, 0)])
def test_ljpeg_streams_and_their_mutations_match_the_jax_decoder(precision, components, pt):
    rng = np.random.default_rng(precision + components)
    samples = rng.integers(0, 1 << precision, (13, 9, components)).astype(np.uint16)
    stream = encode_ljpeg(samples, precision, pt=pt)
    _assert_same(_outcome(traw.ljpeg_decode, stream), _outcome(jraw.ljpeg_decode, stream))
    for _ in range(40):
        blob = bytearray(stream)
        for _ in range(int(rng.integers(1, 6))):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        blob = bytes(blob[: int(rng.integers(2, len(blob) + 1))])
        _assert_same(_outcome(traw.ljpeg_decode, blob), _outcome(jraw.ljpeg_decode, blob))


# -- baseline DCT (lossy DNG) -------------------------------------------------

def _pil_jpeg(arr, mode, **save_kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **save_kw)
    return buf.getvalue()


def _gray_wave():
    x = np.linspace(0, 2 * np.pi, 64)
    return ((np.sin(x)[None, :] * np.cos(x)[:, None]) * 100 + 128).astype(np.uint8)


JPEG_STREAMS = {
    "gray_q50": lambda: _pil_jpeg(_gray_wave(), "L", quality=50),
    "gray_q75": lambda: _pil_jpeg(_gray_wave(), "L", quality=75),
    "gray_q95": lambda: _pil_jpeg(_gray_wave(), "L", quality=95),
    "noise_odd_dims": lambda: _pil_jpeg(np.random.default_rng(1).integers(
        0, 256, (37, 53), dtype=np.uint8), "L", quality=92),
    "color_444": lambda: _pil_jpeg(np.random.default_rng(2).integers(
        0, 256, (40, 48, 3), dtype=np.uint8), "RGB", quality=90, subsampling=0),
    "restart_markers": lambda: _pil_jpeg(np.random.default_rng(3).integers(
        0, 256, (32, 40), dtype=np.uint8), "L", quality=90, restart_marker_rows=1),
    "progressive_rejected": lambda: _pil_jpeg(np.zeros((16, 16), np.uint8), "L", quality=90,
                                              progressive=True),
    "subsampled_rejected": lambda: _pil_jpeg(np.random.default_rng(4).integers(
        0, 256, (32, 32, 3), dtype=np.uint8), "RGB", quality=90, subsampling=2),
}


@pytest.mark.parametrize("name", sorted(JPEG_STREAMS))
def test_jpegdct_matches_the_jax_decoder(name):
    stream = JPEG_STREAMS[name]()
    got = _outcome(traw.jpegdct_decode, stream)
    _assert_same(got, _outcome(jraw.jpegdct_decode, stream))
    assert (got[0] == "error") == name.endswith("rejected")
    if got[0] == "error":
        assert "unsupported JPEG feature" in got[2]


def test_jpegdct_mutations_match_the_jax_decoder():
    rng = np.random.default_rng(5)
    stream = JPEG_STREAMS["restart_markers"]()
    for _ in range(60):
        blob = bytearray(stream)
        for _ in range(int(rng.integers(1, 6))):
            blob[int(rng.integers(0, len(blob)))] = int(rng.integers(0, 256))
        blob = bytes(blob[: int(rng.integers(2, len(blob) + 1))])
        _assert_same(_outcome(traw.jpegdct_decode, blob), _outcome(jraw.jpegdct_decode, blob))


# -- TIFF LZW decode ----------------------------------------------------------

def _lzw_cases(rng):
    """(stream, max_bytes) pairs: encodings of random and runs-heavy data
    (table resets at 12 bits included), garbage, and truncated or mutated
    encodings, each unbounded, at the data's size and at a random bound."""
    for k in range(60):
        n = int(rng.integers(1, 9000))
        levels = 256 if k % 3 == 0 else int(rng.integers(2, 9))
        data = rng.integers(0, levels, n, dtype=np.uint8).tobytes()
        enc = tdeep._lzw_encode(data)
        streams = [enc, rng.integers(0, 256, int(rng.integers(1, 600)), dtype=np.uint8).tobytes()]
        cut = bytearray(enc[: int(rng.integers(1, len(enc) + 1))])
        for _ in range(int(rng.integers(0, 4))):
            cut[int(rng.integers(0, len(cut)))] = int(rng.integers(0, 256))
        streams.append(bytes(cut))
        for s in streams:
            for bound in (None, n, int(rng.integers(0, 2 * n + 2))):
                yield data, enc, s, bound


def test_native_lzw_decode_matches_the_pure_decoder():
    """Same bytes, or the same IndexError, on every stream and bound; the
    JAX package's pure decoder agrees on the streams it decodes."""
    rng = np.random.default_rng(17)
    errors = 0
    for data, enc, stream, bound in _lzw_cases(rng):
        want = _outcome(tdeep._lzw_decode_plain, stream, bound)
        _assert_bytes(_outcome(tdeep._lzw_decode, stream, bound), want)
        _assert_bytes(_outcome(jdeep._lzw_decode, stream, bound), want)
        errors += want[0] == "error"
        if stream is enc and bound == len(data):
            assert want[1] == data
    assert errors  # garbage streams reach the refusal


def _assert_bytes(got, want):
    assert got[0] == want[0]
    assert got[1:] == want[1:]


def test_native_lzw_decode_of_a_megabyte():
    """A 1 MiB strip of smooth 16-bit samples round-trips through the
    native encoder and decoder, equal to the pure decoder's bytes."""
    rng = np.random.default_rng(3)
    data = (np.cumsum(rng.integers(-3, 4, 1 << 19)) % 65536).astype("<u2").tobytes()
    enc = tdeep._lzw_encode(data)
    assert tdeep._lzw_decode(enc, len(data)) == data == tdeep._lzw_decode_plain(enc, len(data))


def test_native_lzw_decode_refuses_a_code_past_the_fresh_table():
    """A first code of 258 (no entry yet) raises IndexError like the pure
    decoder's list lookup."""
    stream = (258 << 7).to_bytes(2, "big")  # one 9-bit code, zero padding
    with pytest.raises(IndexError):
        tdeep._lzw_decode_plain(stream)
    with pytest.raises(IndexError):
        tdeep._lzw_decode(stream)


# -- NeuQuant ------------------------------------------------------------------

def _frame(shape, seed, smooth):
    rng = np.random.default_rng(seed)
    if smooth:
        y, x = np.mgrid[0:shape[0], 0:shape[1]]
        return np.stack([x * 255 // max(shape[1] - 1, 1), y * 255 // max(shape[0] - 1, 1),
                         (x ^ y) & 255, 255 - (x & 63)], axis=-1).astype(np.uint8)
    return rng.integers(0, 256, shape + (4,), np.uint8)


@pytest.mark.parametrize("shape,seed,smooth,colors", [
    ((17, 23), 0, False, 256), ((64, 64), 1, True, 256), ((100, 37), 2, False, 16),
    ((120, 90), 3, True, 2), ((61, 53), 4, False, 97)])
def test_native_neuquant_matches_numpy_and_the_jax_package(shape, seed, smooth, colors):
    frame = _frame(shape, seed, smooth)
    pal, idx = tneuquant.quantize_rgba(frame, colors)
    for other in (tneuquant.quantize_rgba_plain(frame, colors),
                  jneuquant.quantize_rgba(frame, colors)):
        np.testing.assert_array_equal(pal, other[0])
        np.testing.assert_array_equal(idx, other[1])
    assert pal.shape == (colors, 3) and idx.shape == (shape[0] * shape[1],)


def test_neuquant_trains_natively(monkeypatch):
    """quantize_rgba never takes the numpy trainer: a GIF frame is the
    C++'s work."""
    monkeypatch.setattr(tneuquant, "_train_python", None)
    pal, idx = tneuquant.quantize_rgba(_frame((40, 30), 9, False), 256)
    assert pal.shape == (256, 3) and idx.dtype == np.uint8
    assert isinstance(native.load().neuquant_quantize, ctypes._CFuncPtr)
