"""The port's ARW / PEF / SRW / ORF / RW2 / RWL ingestion against the JAX
package's, at tolerance 0: each case writes its files with the JAX tests'
writers (tests/test_raw_families.py) and both packages must give the same
RGBA bytes or the same error.  The cases mirror tests/test_raw_families.py
one by one, plus a TIFF/EP raw with a colour matrix."""

import struct

import numpy as np
import pytest

from paintfe_tpu.io import raw as jraw
from paintfe_tpu_torch.io import raw as traw
from tests.test_raw_families import write_rw2, write_tiffep
from tests.test_torch_raw_dng import assert_fuzz_agrees, assert_same_decode

_LOADERS = {".arw": (jraw.load_arw, traw.load_arw), ".pef": (jraw.load_pef, traw.load_pef),
            ".srw": (jraw.load_srw, traw.load_srw), ".orf": (jraw.load_orf, traw.load_orf),
            ".rw2": (jraw.load_rw2, traw.load_rw2), ".rwl": (jraw.load_rw2, traw.load_rw2)}


def _tiffep(ext, bits):
    def make(d):
        rng = np.random.default_rng(sum(map(ord, ext)) + bits)
        mosaic = rng.integers(0, 1 << bits, (14, 18)).astype(np.uint16)
        write_tiffep(d / f"x.{ext}", mosaic, bits=bits, magic=0x4F52 if ext == "orf" else None)
    return make


def _orf_sr_magic(d):
    write_tiffep(d / "sr.orf", np.full((8, 10), 900, np.uint16), bits=12, magic=0x5253,
                 make="OLYMPUS")


def _arw_lossless_jpeg(d):
    mosaic = np.random.default_rng(5).integers(0, 1 << 14, (12, 16)).astype(np.uint16)
    write_tiffep(d / "l.arw", mosaic, bits=14, compression=7)
    write_tiffep(d / "u.arw", mosaic, bits=14, compression=1)


def _black_white_neutral(d):
    write_tiffep(d / "wb.arw", np.full((16, 16), 1200, np.uint16), bits=12, black=100,
                 white=3000, neutral=(0.5, 1.0, 0.8))


def _proprietary(ext, comp):
    def make(d):
        write_tiffep(d / f"c.{ext}", np.zeros((8, 8), np.uint16), bits=12, compression=comp)
    return make


def _orf_short_strip(d):
    write_tiffep(d / "c.orf", np.full((8, 10), 500, np.uint16), bits=12, magic=0x4F52)
    (d / "c.orf").write_bytes((d / "c.orf").read_bytes()[:-60])


def _rw2_cfa_enums(d):
    mosaic = np.random.default_rng(9).integers(0, 1 << 12, (12, 14)).astype(np.uint16)
    for cfa in (1, 2, 3, 4):
        write_rw2(d / f"p{cfa}.rw2", mosaic, cfa=cfa)


def _rw2_borders_blacks_balance(d):
    write_rw2(d / "b.rw2", np.full((16, 20), 1000, np.uint16), borders=(1, 1, 13, 17),
              black=(64, 64, 64), red_bal=512, blue_bal=320)


def _rw2_noisy_blacks(d):
    """Per-colour blacks that differ and a noisy mosaic: the divisor
    white - max(black) is a host scalar that is no power of two."""
    mosaic = np.random.default_rng(10).integers(0, 1 << 12, (18, 22)).astype(np.uint16)
    write_rw2(d / "n.rw2", mosaic, cfa=3, borders=(3, 2, 17, 21), black=(60, 63, 71),
              red_bal=470, blue_bal=333)


def _rw2_packed(d):
    write_rw2(d / "t.rw2", np.full((10, 12), 800, np.uint16), truncate=True)


def _rwl(d):
    write_rw2(d / "l.rwl", np.full((8, 10), 700, np.uint16))


def _tiffep_color_matrix(d):
    """ColorMatrix1 on a TIFF/EP raw takes the host matrix step."""
    mosaic = np.random.default_rng(11).integers(0, 1 << 12, (12, 16)).astype(np.uint16)
    write_tiffep(d / "m.pef", mosaic, bits=12, neutral=(0.6, 1.0, 0.7), black=64, white=4000)
    blob = bytearray((d / "m.pef").read_bytes())
    # append a ColorMatrix1 (SRATIONAL x9) to the CFA SubIFD: rewrite that
    # IFD at the end of the file with one more entry
    (sub_off,) = struct.unpack_from("<I", blob, blob.find(struct.pack("<HHI", 330, 4, 1)) + 8)
    (n,) = struct.unpack_from("<H", blob, sub_off)
    entries = [bytes(blob[sub_off + 2 + 12 * k:sub_off + 14 + 12 * k]) for k in range(n)]
    cm = [(14000, 10000), (-5000, 10000), (-1000, 10000), (-3000, 10000), (12500, 10000),
          (800, 10000), (-200, 10000), (1500, 10000), (6000, 10000)]
    payload = b"".join(struct.pack("<ii", a, b) for a, b in cm)
    new_off = len(blob)
    data_off = new_off + 2 + 12 * (n + 1) + 4
    entries.append(struct.pack("<HHII", 50721, 10, 9, data_off))
    entries.sort(key=lambda e: struct.unpack_from("<H", e)[0])
    blob += struct.pack("<H", n + 1) + b"".join(entries) + struct.pack("<I", 0) + payload
    struct.pack_into("<I", blob, blob.find(struct.pack("<HHI", 330, 4, 1)) + 8, new_off)
    (d / "m.pef").write_bytes(bytes(blob))


def _tiffep_empty_raster(d):
    """A TIFF/EP raw of height 0 with levels and AsShotNeutral: refused in
    both packages."""
    write_tiffep(d / "empty.srw", np.zeros((0, 8), np.uint16), bits=16, black=10, white=4000,
                 neutral=(0.5, 1.0, 0.8))


CASES = {
    "tiffep_empty_raster": _tiffep_empty_raster,
    "orf_sr_magic_variant": _orf_sr_magic, "arw_lossless_jpeg": _arw_lossless_jpeg,
    "tiffep_black_white_and_neutral": _black_white_neutral,
    "arw2_curve_error": _proprietary("arw", 32767),
    "pentax_compressed_error": _proprietary("pef", 65535),
    "orf_short_strip": _orf_short_strip, "rw2_cfa_enums": _rw2_cfa_enums,
    "rw2_borders_blacks_balance": _rw2_borders_blacks_balance,
    "rw2_noisy_blacks": _rw2_noisy_blacks, "rw2_packed_error": _rw2_packed,
    "rwl_routes_to_rw2": _rwl, "tiffep_color_matrix": _tiffep_color_matrix,
}
CASES.update({f"tiffep_{ext}_{bits}": _tiffep(ext, bits)
              for ext, bits in (("arw", 16), ("arw", 14), ("pef", 12), ("pef", 16),
                                ("srw", 12), ("srw", 16), ("orf", 12), ("orf", 16))})


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_raw_decodes_like_the_jax_package(tmp_path, case):
    CASES[case](tmp_path)
    for path in sorted(tmp_path.iterdir()):
        assert_same_decode(path)
        assert_same_decode(path, *_LOADERS[path.suffix])


def test_the_color_matrix_case_takes_the_matrix_step(tmp_path):
    _tiffep_color_matrix(tmp_path)
    _, ifds = traw._all_ifds((tmp_path / "m.pef").read_bytes())
    assert any(len(t.get(traw.T_COLOR_MATRIX1, [])) == 9 for t in ifds)


@pytest.mark.parametrize("ext", ["arw", "pef", "srw", "orf", "rw2"])
def test_families_fuzz_agrees_with_the_jax_package(tmp_path, ext):
    """Byte mutations of every family's container: equal bytes or the same
    error, through load_image in both packages."""
    rng = np.random.default_rng(123)
    mosaic = rng.integers(0, 1 << 12, (10, 12)).astype(np.uint16)
    base = tmp_path / f"f.{ext}"
    if ext == "rw2":
        write_rw2(base, mosaic)
    else:
        write_tiffep(base, mosaic, bits=12, magic=0x4F52 if ext == "orf" else None)
    assert_fuzz_agrees(base.read_bytes(), tmp_path / f"fuzz.{ext}", rng, 40, *_LOADERS[f".{ext}"],
                       min_len=8)
    assert_same_decode(base)  # the pristine file still decodes
