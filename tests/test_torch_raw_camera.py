"""The port's Canon CR2 and Nikon NEF/NRW ingestion against the JAX
package's, at tolerance 0: each case writes its files with the JAX tests'
writers (tests/test_raw_camera.py) and both packages must give the same
RGBA bytes or the same error.  The cases mirror tests/test_raw_camera.py
one by one."""

import numpy as np
import pytest

from paintfe_tpu.io import raw as jraw
from paintfe_tpu_torch.io import raw as traw
from tests.ljpeg_writer import encode_ljpeg
from tests.test_raw_camera import write_cr2, write_nef
from tests.test_torch_raw_dng import assert_fuzz_agrees, assert_same_decode


def _cr2_constant(d):
    write_cr2(d / "c.cr2", np.full((16, 24), 8000, np.uint16))


def _cr2_slices(d):
    mosaic = np.random.default_rng(21).integers(0, 1 << 14, (12, 30)).astype(np.uint16)
    write_cr2(d / "flat.cr2", mosaic)
    write_cr2(d / "sliced.cr2", mosaic, slices=(2, 10, 10))


def _cr2_sensor_crop_black(d):
    full = np.full((20, 32), 1000, np.uint16)
    full[2:18, 8:30] = 9000
    write_cr2(d / "crop.cr2", full, sensor_info=[17, 32, 20, 0, 0, 8, 2, 29, 17] + [0] * 8)


def _cr2_noisy_border_black(d):
    """A masked border of noise: the black level is numpy's f32 mean of it,
    a value with a fraction, and the divisor a host scalar that is no
    power of two."""
    rng = np.random.default_rng(22)
    full = rng.integers(900, 1100, (24, 40)).astype(np.uint16)
    full[2:22, 8:38] = rng.integers(1000, 16000, (20, 30))
    write_cr2(d / "noisy.cr2", full, sensor_info=[17, 40, 24, 0, 0, 8, 2, 37, 21] + [0] * 8,
              wb_rggb=(2048, 1024, 1024, 1536))


def _cr2_as_shot_wb(d):
    write_cr2(d / "wb.cr2", np.full((16, 16), 1500, np.uint16),
              wb_rggb=(2048, 1024, 1024, 1536))


def _cr2_unknown_colordata(d):
    write_cr2(d / "wbx.cr2", np.full((16, 16), 1500, np.uint16),
              wb_rggb=(2048, 1024, 1024, 1536), colordata_count=70)


def _cr2_garbage(d):
    (d / "x.cr2").write_bytes(b"II*\0" + b"\0" * 16)


def _cr2_dark_14bit(d):
    write_cr2(d / "dark.cr2", np.full((12, 16), 1000, np.uint16), precision=14)


def _nef_packed(bits):
    def make(d):
        mosaic = np.random.default_rng(31).integers(0, 1 << bits, (14, 18)).astype(np.uint16)
        write_nef(d / f"p{bits}.nef", mosaic, bits=bits)
    return make


def _nef_as_shot_wb(d):
    write_nef(d / "wb.nef", np.full((16, 16), 1200, np.uint16), bits=12,
              wb_rb=(2.0, 1.5, 1.0, 1.0))


def _nef_wb_in_later_ifd(d):
    write_nef(d / "wb2.nef", np.full((16, 16), 1200, np.uint16), bits=12,
              wb_rb=(2.0, 1.5, 1.0, 1.0), wb_in_later_ifd=True)


def _nef_compressed(d):
    write_nef(d / "c.nef", np.zeros((8, 8), np.uint16), bits=12, compression=34713)


def _nef_odd_sample_count(d):
    mosaic = np.random.default_rng(41).integers(0, 1 << 12, (9, 9)).astype(np.uint16)
    write_nef(d / "odd.nef", mosaic, bits=12)


def _nef_empty_raster(d):
    """A NEF of height 0 with a white balance: the JAX package's demosaic
    refuses the empty raster (a RawError), and so does the port's."""
    write_nef(d / "empty.nef", np.zeros((0, 8), np.uint16), bits=12, wb_rb=(2.0, 1.5, 1.0, 1.0))


def _nrw(d):
    """.nrw routes to the NEF loader in both packages."""
    mosaic = np.random.default_rng(42).integers(0, 1 << 14, (10, 14)).astype(np.uint16)
    write_nef(d / "x.nrw", mosaic, bits=14, wb_rb=(1.8, 1.3, 1.0, 1.0))


CASES = {
    "cr2_constant_field": _cr2_constant, "cr2_slices_reassemble": _cr2_slices,
    "cr2_sensor_crop_and_black": _cr2_sensor_crop_black,
    "cr2_noisy_border_black": _cr2_noisy_border_black,
    "cr2_as_shot_white_balance": _cr2_as_shot_wb,
    "cr2_unknown_colordata_count": _cr2_unknown_colordata,
    "cr2_garbage": _cr2_garbage, "cr2_dark_14bit": _cr2_dark_14bit,
    "nef_as_shot_white_balance": _nef_as_shot_wb, "nef_wb_in_later_ifd": _nef_wb_in_later_ifd,
    "nef_compressed_clear_error": _nef_compressed,
    "nef_odd_sample_count": _nef_odd_sample_count, "nrw_routes_to_nef": _nrw,
    "nef_empty_raster": _nef_empty_raster,
}
CASES.update({f"nef_packed_{bits}": _nef_packed(bits) for bits in (12, 14, 16)})

_LOADERS = {".cr2": (jraw.load_cr2, traw.load_cr2), ".nef": (jraw.load_nef, traw.load_nef),
            ".nrw": (jraw.load_nef, traw.load_nef)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_camera_raw_decodes_like_the_jax_package(tmp_path, case):
    CASES[case](tmp_path)
    for path in sorted(tmp_path.iterdir()):
        assert_same_decode(path)
        assert_same_decode(path, *_LOADERS[path.suffix])


@pytest.mark.parametrize("family", ["cr2", "nef"])
def test_camera_fuzz_agrees_with_the_jax_package(tmp_path, family):
    """Mutations of CR2/NEF containers: equal bytes or the same error."""
    rng = np.random.default_rng(77)
    mosaic = rng.integers(0, 1 << 14, (10, 12)).astype(np.uint16)
    base = tmp_path / f"b.{family}"
    if family == "cr2":
        write_cr2(base, mosaic, slices=(1, 6, 6))
    else:
        write_nef(base, mosaic, bits=12)
    jload, tload = _LOADERS[base.suffix]
    assert_fuzz_agrees(base.read_bytes(), tmp_path / "fuzz.bin", rng, 60, jload, tload)


def test_cr2_black_level_is_the_hosts_f32_mean(tmp_path):
    """The CR2 black level is numpy's f32 pairwise mean of the masked
    border, on the host: the same Python float as the JAX package's, where
    an f64 mean of the same samples differs."""
    rng = np.random.default_rng(23)
    full = rng.integers(0, 16383, (64, 400)).astype(np.uint16)
    border = full[2:62, :398 - 2].astype(np.float32)
    assert float(np.mean(border)) != float(np.mean(border.astype(np.float64)))
    write_cr2(tmp_path / "b.cr2", full, sensor_info=[17, 400, 64, 0, 0, 398, 2, 399, 61]
              + [0] * 8)
    assert_same_decode(tmp_path / "b.cr2", jraw.load_cr2, traw.load_cr2)


def test_ljpeg_stream_of_a_cr2_decodes_like_the_jax_package():
    samples = np.random.default_rng(24).integers(0, 1 << 14, (9, 8, 2)).astype(np.uint16)
    stream = encode_ljpeg(samples, 14)
    got, prec = traw.ljpeg_decode_full(stream)
    want, want_prec = jraw.ljpeg_decode_full(stream)
    assert prec == want_prec == 14
    np.testing.assert_array_equal(got, want)
