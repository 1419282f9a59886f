"""The RAW path of the port's batch CLI against the JAX package's CLI: every
RAW family and extension, written by chip_smoke's own writers (raw_files:
the files of the smoke's RAW phase, here at 64x40), through the headline
script serially (-f jpeg, -f tiff) and the headline and spatial scripts
under --shard, with --device cpu; each output file byte-equal to the JAX
CLI's.  The smoke's vectorised lossless-JPEG writer is held against
tests/ljpeg_writer.py, and its launch arithmetic against the buckets."""

import shutil

import numpy as np
import pytest

import chip_smoke
from paintfe_tpu import cli as jcli
from paintfe_tpu.io import codecs as jcodecs
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch.io import codecs as tcodecs
from tests.ljpeg_writer import encode_ljpeg

H, W = 40, 64


@pytest.fixture(scope="module")
def raw_inputs(tmp_path_factory):
    """chip_smoke.raw_files at H x W, plus the extensions that route to a
    donor family's reader (.nrw -> NEF, .rwl -> RW2, .pef/.srw/.orf -> the
    TIFF/EP reader) as copies."""
    root = tmp_path_factory.mktemp("raw")
    (root / "in").mkdir()
    files = chip_smoke.raw_files(root / "in", H, W)
    for src, dst in (("nikon.nef", "nikon2.nrw"), ("panasonic.rw2", "leica.rwl"),
                     ("sony.arw", "pentax.pef"), ("sony.arw", "samsung.srw"),
                     ("sony.arw", "olympus.orf")):
        shutil.copy(root / "in" / src, root / "in" / dst)
    (root / "headline.rhai").write_text(chip_smoke.HEADLINE)
    (root / "spatial.rhai").write_text(chip_smoke.SPATIAL)
    return root, files


def test_the_smoke_files_decode_like_the_jax_package(raw_inputs):
    root, files = raw_inputs
    names = sorted(p.name for p in (root / "in").iterdir())
    assert len(names) == len(files) + 5
    for name in names:
        want = jcodecs.load_image(root / "in" / name)
        got = tcodecs.load_image(root / "in" / name, device="cpu")
        np.testing.assert_array_equal(got, want)
        if name in files:
            assert got.shape[:2] == files[name][1]


@pytest.mark.parametrize("script,extra", [("headline", ["-f", "jpeg"]),
                                          ("headline", ["-f", "tiff"]),
                                          ("headline", ["-f", "png", "--shard"]),
                                          ("spatial", ["-f", "png", "--shard"])])
def test_raw_cli_gives_the_jax_clis_files(raw_inputs, tmp_path, script, extra):
    root, _ = raw_inputs
    common = ["-i", str(root / "in" / "*"), "-s", str(root / f"{script}.rhai"), *extra]
    assert tcli.main(common + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jcli.main(common + ["--output-dir", str(tmp_path / "j")]) == 0
    want = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == want and len(want) == 13
    for name in want:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_raw_animate_gif_gives_the_jax_clis_bytes(tmp_path):
    chip_smoke.raw_gif_files(tmp_path, 36, 52)
    (tmp_path / "fx.rhai").write_text(chip_smoke.HEADLINE)
    common = ["-i", *(str(tmp_path / n) for n in chip_smoke.RAW_GIF), "-s",
              str(tmp_path / "fx.rhai"), "--fps", "8"]
    assert tcli.main(common + ["--animate", str(tmp_path / "t.gif"), "--device", "cpu"]) == 0
    assert jcli.main(common + ["--animate", str(tmp_path / "j.gif")]) == 0
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()


def test_raw_device_reaches_every_route(raw_inputs, tmp_path, monkeypatch):
    """--device reaches the develop stage serially, in --shard's decode-ahead
    threads and in --animate: every RAW load asks for the CLI's device."""
    from paintfe_tpu_torch.io import raw

    root, _ = raw_inputs
    seen = []
    real = raw._guarded

    def spy(family, decode, path, device):
        seen.append(str(device))
        return real(family, decode, path, device)

    monkeypatch.setattr(raw, "_guarded", spy)
    inputs = [str(root / "in" / "sony.arw"), str(root / "in" / "nikon.nef")]
    for extra in ([], ["--shard"], ["--animate", str(tmp_path / "a.png")]):
        seen.clear()
        argv = ["-i", *inputs, "-s", str(root / "headline.rhai"), "--device", "cpu", *extra]
        if "--animate" not in extra:
            argv += ["--output-dir", str(tmp_path / f"o{len(extra)}")]
        assert tcli.main(argv) == 0
        assert seen == ["cpu", "cpu"]


@pytest.mark.parametrize("shape,nc,precision", [((9, 7), 1, 16), ((12, 10), 2, 14),
                                                ((5, 6), 3, 12), ((16, 16), 2, 8)])
def test_smoke_ljpeg_writer_matches_the_test_writer(shape, nc, precision):
    """chip_smoke.ljpeg_bytes writes tests/ljpeg_writer.py's bytes
    (predictor 1), noise and flat runs, so its 24 MP streams are streams
    the decoders are tested on."""
    rng = np.random.default_rng(nc + precision)
    samples = rng.integers(0, 1 << precision, shape + (nc,)).astype(np.uint16)
    samples[: shape[0] // 2, : shape[1] // 2] = 1 << (precision - 1)
    assert chip_smoke.ljpeg_bytes(samples, precision) == encode_ljpeg(samples, precision)
    if nc == 1:
        assert chip_smoke.ljpeg_bytes(samples[..., 0], precision) == encode_ljpeg(samples,
                                                                                 precision)


def test_raw_launch_counts_follow_the_shape_buckets():
    files = {"a.nef": ("nef", (4000, 6000)), "b.arw": ("arw", (4000, 6000)),
             "c.rw2": ("rw2", (3984, 5968))}
    runs = {"s": (("a.nef", "b.arw", "c.rw2"), "spatial", ["-f", "jpeg", "--shard"], "o"),
            "h": (("a.nef", "c.rw2"), "headline", ["-f", "tiff"], "p")}
    got = chip_smoke.raw_launches(files, runs)
    assert got["s"] == {"gaussian_blur_fused": 2, "median_kernel": 2, "gather_bilinear_u8": 2}
    assert got["h"] == {"gaussian_blur_fused": 2, "median_kernel": 0, "gather_bilinear_u8": 0}
