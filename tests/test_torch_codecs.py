"""The port's own codec, GIF quantizer and prefetcher (paintfe_tpu_torch.io,
parallel/prefetch.py) against the JAX package's: the same file bytes for
every output format the CLI offers, the same decoded pixels, the same
NeuQuant palette and indices (whichever trainer the JAX package uses), and
a guard that no module of the port, nor chip_smoke.py, imports JAX or the
JAX package."""

import ast
import pathlib

import numpy as np
import pytest
from PIL import Image

from paintfe_tpu import cli as jcli
from paintfe_tpu.io import codecs as jcodecs
from paintfe_tpu.io import neuquant as jneuquant
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch.io import codecs as tcodecs
from paintfe_tpu_torch.io import neuquant as tneuquant
from paintfe_tpu_torch.parallel.prefetch import prefetch_images

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _img(shape, seed, smooth=False):
    rng = np.random.default_rng(seed)
    if smooth:  # gradients: a palette with structure, not noise
        y, x = np.mgrid[0:shape[0], 0:shape[1]]
        a = np.stack([x * 255 // max(shape[1] - 1, 1), y * 255 // max(shape[0] - 1, 1),
                      (x ^ y) & 255, 255 - (x & 63)], axis=-1).astype(np.uint8)
        return a
    img = rng.integers(0, 256, shape + (4,), np.uint8)
    img[:3, :, 3] = 0
    return img


SAVES = [
    ("png", {}), ("jpeg", {"quality": 75}), ("webp", {}),
    ("webp", {"webp_lossless": False, "quality": 60}), ("bmp", {}),
    ("tga", {}), ("ico", {}), ("tiff", {}), ("tiff", {"tiff_compression": "lzw"}),
    ("tiff", {"tiff_compression": "deflate"}), ("gif", {}),
]


@pytest.mark.parametrize("fmt,kw", SAVES, ids=[f"{f}-{i}" for i, (f, _) in enumerate(SAVES)])
@pytest.mark.parametrize("smooth", [False, True])
def test_save_image_gives_the_jax_bytes(tmp_path, fmt, kw, smooth):
    img = _img((48, 61), 3, smooth)
    ext = tcodecs.format_extension(fmt)
    jcodecs.save_image(img, tmp_path / f"j.{ext}", fmt, **kw)
    tcodecs.save_image(img, tmp_path / f"t.{ext}", fmt, **kw)
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    np.testing.assert_array_equal(tcodecs.load_image(tmp_path / f"t.{ext}"),
                                  jcodecs.load_image(tmp_path / f"j.{ext}"))


@pytest.mark.parametrize("shape,seed,smooth", [((17, 23), 0, False), ((64, 64), 1, True),
                                               ((100, 37), 2, False), ((180, 150), 3, True),
                                               ((300, 200), 4, False)])
def test_neuquant_matches_the_jax_package(shape, seed, smooth):
    frame = _img(shape, seed, smooth)
    tpal, tidx = tneuquant.quantize_rgba(frame, 256)
    jpal, jidx = jneuquant.quantize_rgba(frame, 256)
    np.testing.assert_array_equal(tpal, jpal)
    np.testing.assert_array_equal(tidx, jidx)


@pytest.mark.parametrize("colors", [2, 16, 100])
def test_neuquant_small_palettes_match(colors):
    frame = _img((40, 50), 5, True)
    for a, b in zip(tneuquant.quantize_rgba(frame, colors),
                    jneuquant.quantize_rgba(frame, colors)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["gif", "tiff", "bmp"])
def test_cli_formats_give_the_jax_bytes(tmp_path, fmt):
    Image.fromarray(_img((30, 44), 6, True), "RGBA").save(tmp_path / "in.png")
    (tmp_path / "fx.rhai").write_text("apply_median(1); apply_bulge(0.4);")
    common = ["-i", str(tmp_path / "in.png"), "-s", str(tmp_path / "fx.rhai"), "-f", fmt]
    assert jcli.main(common + ["--output-dir", str(tmp_path / "j")]) == 0
    assert tcli.main(common + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    ext = tcodecs.format_extension(fmt)
    assert ((tmp_path / "t" / f"in.{ext}").read_bytes()
            == (tmp_path / "j" / f"in.{ext}").read_bytes())


def test_raw_inputs_report_not_yet_ported(tmp_path):
    """RAW is ported: a malformed DNG is a decode error of the RAW reader
    and the families without a decoder keep the JAX package's message,
    in both packages the same."""
    (tmp_path / "shot.dng").write_bytes(b"II*\0")
    (tmp_path / "shot.raf").write_bytes(b"FUJIFILMCCD-RAW ")
    for name, match in (("shot.dng", "failed to decode DNG"), ("shot.raf", "raw decoder")):
        with pytest.raises(tcodecs.CodecError, match=match) as got:
            tcodecs.load_image(tmp_path / name, device="cpu")
        with pytest.raises(jcodecs.CodecError) as want:
            jcodecs.load_image(tmp_path / name)
        assert str(got.value) == str(want.value)
        assert "not yet ported" not in str(got.value)


def test_undecodable_input_is_a_codec_error(tmp_path):
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(tcodecs.CodecError, match="failed to decode"):
        tcodecs.load_image(tmp_path / "bad.png")


def test_prefetch_keeps_order_and_delivers_errors_in_slot(tmp_path):
    paths = []
    for k in range(7):
        p = tmp_path / f"{k}.png"
        if k == 3:
            p.write_bytes(b"broken")
        else:
            Image.fromarray(np.full((4, 5, 4), k, np.uint8), "RGBA").save(p)
        paths.append(p)
    got = list(prefetch_images(paths, depth=2, workers=3))
    assert [p for p, _ in got] == paths
    for k, (_, img) in enumerate(got):
        if k == 3:
            assert isinstance(img, tcodecs.CodecError)
        else:
            assert img.shape == (4, 5, 4) and int(img[0, 0, 0]) == k


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_sources():
    return sorted((ROOT / "paintfe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paintfe_tpu")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
