"""The port's CLI (paintfe_tpu_torch.cli) against paintfe_tpu.cli.main on
the same seeded PNGs — serial and --shard, --device cpu — plus its exit
codes, and a guard that the port never imports JAX."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from paintfe_tpu import cli as jcli
from paintfe_tpu_torch import cli as tcli

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEADLINE = ("apply_blur(2.0); apply_brightness_contrast(10.0, 20.0); "
            "apply_levels(10.0, 245.0, 1.1); apply_sepia(0.5);")


@pytest.fixture
def inputs(tmp_path):
    rng = np.random.default_rng(31)
    shapes = [(40, 52), (40, 52), (33, 70)]
    for k, (h, w) in enumerate(shapes):
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        img[:5, :, 3] = 0
        Image.fromarray(img, "RGBA").save(tmp_path / f"in{k}.png")
    (tmp_path / "fx.rhai").write_text(HEADLINE + ' print_line("done");')
    return tmp_path


def _decoded(d):
    return {p.name: np.asarray(Image.open(p)) for p in sorted(d.glob("*.png"))}


@pytest.mark.parametrize("shard", [False, True])
def test_cli_matches_jax_cli(inputs, shard):
    common = ["-i", str(inputs / "in*.png"), "-s", str(inputs / "fx.rhai"),
              "-f", "png"]
    assert jcli.main(common + ["--output-dir", str(inputs / "jax")]) == 0
    extra = ["--shard"] if shard else []
    assert tcli.main(common + ["--output-dir", str(inputs / "port"),
                               "--device", "cpu", *extra]) == 0
    ref, out = _decoded(inputs / "jax"), _decoded(inputs / "port")
    assert sorted(out) == sorted(ref) == ["in0.png", "in1.png", "in2.png"]
    for name in ref:
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


@pytest.mark.parametrize("shard", [False, True])
def test_spatial_effects_cli_matches_jax_cli(inputs, shard):
    (inputs / "fx2.rhai").write_text("apply_median(2); apply_bulge(0.5);")
    common = ["-i", str(inputs / "in*.png"), "-s", str(inputs / "fx2.rhai"),
              "-f", "png"]
    assert jcli.main(common + ["--output-dir", str(inputs / "jax")]) == 0
    extra = ["--shard"] if shard else []
    assert tcli.main(common + ["--output-dir", str(inputs / "port"),
                               "--device", "cpu", *extra]) == 0
    ref, out = _decoded(inputs / "jax"), _decoded(inputs / "port")
    assert sorted(out) == sorted(ref) == ["in0.png", "in1.png", "in2.png"]
    for name in ref:
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


def test_run_one_defaults_to_the_card(inputs):
    import inspect

    assert inspect.signature(tcli.run_one).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.run_one(inputs / "in0.png", inputs / "o.png", None, "png", 90,
                     True, "none", True, False)
    assert not (inputs / "o.png").exists()


def test_cli_without_script_copies_pixels(inputs):
    assert tcli.main(["-i", str(inputs / "in0.png"), "-o",
                      str(inputs / "o.png"), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(inputs / "o.png")),
                                  np.asarray(Image.open(inputs / "in0.png")))


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("script,match", [
    ("let x = ;", "script error"),
    ("apply_twist(2.0);", "apply_twist is not yet ported"),
])
def test_script_failures_keep_going_with_rc_1(inputs, capsys, shard, script, match):
    (inputs / "bad.rhai").write_text(script)
    argv = ["-i", str(inputs / "in*.png"), "-s", str(inputs / "bad.rhai"),
            "--output-dir", str(inputs / "out"), "--device", "cpu"]
    assert tcli.main(argv + (["--shard"] if shard else [])) == 1
    assert match in capsys.readouterr().err


def test_missing_input_is_rc_1(tmp_path, capsys):
    assert tcli.main(["-i", str(tmp_path / "nope*.png"), "--device", "cpu"]) == 1
    assert "matched no files" in capsys.readouterr().err


def test_one_bad_input_fails_the_run_but_not_the_others(inputs, capsys):
    (inputs / "broken.png").write_bytes(b"not a png")
    argv = ["-i", str(inputs / "in0.png"), str(inputs / "broken.png"),
            "--output-dir", str(inputs / "out"), "--device", "cpu"]
    assert tcli.main(argv) == 1
    assert (inputs / "out" / "in0.png").exists()


@pytest.mark.parametrize("argv,match", [
    (["--animate", "a.gif"], "--animate is not yet ported"),
    (["--trace-dir", "tr"], "--trace-dir is not yet ported"),
    (["-f", "pfe"], ".pfe output is not yet ported"),
])
def test_unported_options_report_per_input(inputs, capsys, argv, match):
    base = ["-i", str(inputs / "in0.png"), "--output-dir", str(inputs / "o"),
            "--device", "cpu"]
    assert tcli.main(base + argv) == 1
    assert match in capsys.readouterr().err


def test_layered_and_16_bit_inputs_report_not_yet_ported(inputs, capsys):
    (inputs / "doc.pfe").write_bytes(b"\0" * 16)
    deep = (np.arange(64 * 3, dtype=np.uint16).reshape(8, 8, 3) * 300)
    # a 16-bit RGB PNG written by hand: PIL writes 16-bit only for gray
    import struct
    import zlib

    raw = b"".join(b"\0" + row.astype(">u2").tobytes() for row in deep)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    (inputs / "deep.png").write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 16, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    for shard in ([], ["--shard"]):
        argv = ["-i", str(inputs / "doc.pfe"), str(inputs / "deep.png"),
                str(inputs / "in0.png"), "--output-dir", str(inputs / "o"),
                "--device", "cpu", *shard]
        assert tcli.main(argv) == 1
        err = capsys.readouterr().err
        assert ".pfe input" in err and "16-bit input" in err
        assert (inputs / "o" / "in0.png").exists()


def test_multi_host_launch_is_not_yet_ported(inputs, capsys, monkeypatch):
    monkeypatch.setenv("PAINTFE_COORDINATOR", "localhost:1234")
    assert tcli.main(["-i", str(inputs / "in0.png"), "--output-dir",
                      str(inputs / "o"), "--device", "cpu", "--shard"]) == 1
    assert "not yet ported" in capsys.readouterr().err


def test_profile_prints_stage_times(inputs, capsys):
    assert tcli.main(["-i", str(inputs / "in0.png"), "-s", str(inputs / "fx.rhai"),
                      "--output-dir", str(inputs / "o"), "--device", "cpu",
                      "--profile", "-v"]) == 0
    out = capsys.readouterr().out
    for stage in ("load:", "script:", "encode:", "[script] done"):
        assert stage in out


def test_device_cuda_without_a_card_exits_nonzero(inputs, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main(["-i", str(inputs / "in0.png"), "--output-dir",
                      str(inputs / "o")]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (inputs / "o" / "in0.png").exists()


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import paintfe_tpu_torch\n"
        "for m in pkgutil.walk_packages(paintfe_tpu_torch.__path__, 'paintfe_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import paintfe_tpu_torch.cli, chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
