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


@pytest.mark.parametrize("shard", [False, True])
def test_effects_cli_matches_jax_cli(inputs, shard):
    (inputs / "fx3.rhai").write_text(
        "apply_box_blur(2); apply_motion_blur(30.0, 3.0); apply_sharpen(1.2); "
        "apply_pixelate(2); apply_crystallize(5); apply_glow(1.0, 0.5); "
        "apply_vignette(0.5, 0.9); apply_oil_painting(2); apply_ink(40.0, 20.0);")
    common = ["-i", str(inputs / "in*.png"), "-s", str(inputs / "fx3.rhai"),
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
    ("apply_pixelate(2.5);", "must be an integer"),
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
    (["--animate", "a.gif"], "a.gif"),
    (["--trace-dir", "tr"], "tr"),
])
def test_unported_options_report_per_input(inputs, capsys, argv, match):
    """--animate and --trace-dir, once refused per input, now run: rc 0 and
    the animation or the trace is written."""
    argv = [str(inputs / a) if a in ("a.gif", "tr") else a for a in argv]
    base = ["-i", str(inputs / "in0.png"), "--output-dir", str(inputs / "o"),
            "--device", "cpu"]
    assert tcli.main(base + argv) == 0
    assert "not yet ported" not in capsys.readouterr().err
    out = inputs / match
    assert out.is_file() if match.endswith(".gif") else any(out.glob("*.json"))


def test_layered_and_16_bit_inputs_report_not_yet_ported(inputs, capsys):
    """A 16-bit RGB PNG, once refused, now runs through both CLIs to the
    same bytes (a 16-bit PNG serially, PIL's 8-bit reading under --shard);
    a corrupt .pdn beside it fails alone with a PdnError, rc 1."""
    (inputs / "doc.pdn").write_bytes(b"\0" * 16)
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
        common = ["-i", str(inputs / "doc.pdn"), str(inputs / "deep.png"),
                  str(inputs / "in0.png"), *shard]
        out, ref = inputs / f"o{len(shard)}", inputs / f"j{len(shard)}"
        assert tcli.main(common + ["--output-dir", str(out), "--device", "cpu"]) == 1
        err = capsys.readouterr().err
        assert "not a Paint.NET file" in err and "not yet ported" not in err
        assert jcli.main(common + ["--output-dir", str(ref)]) == 1
        for name in ("deep.png", "in0.png"):
            assert (out / name).read_bytes() == (ref / name).read_bytes(), name
        assert (out / "deep.png").read_bytes()[24] == (8 if shard else 16)  # IHDR depth
        assert not (out / "doc.png").exists()


def test_multi_host_launch_is_not_yet_ported(inputs, capsys, monkeypatch):
    """A multi-process launch runs since the multi-GPU layer was ported
    (tests/test_torch_distributed.py); a coordinator alone is partial
    wiring, refused with rc 1 and the missing variables named."""
    monkeypatch.setenv("PAINTFE_COORDINATOR", "localhost:1234")
    assert tcli.main(["-i", str(inputs / "in0.png"), "--output-dir",
                      str(inputs / "o"), "--device", "cpu", "--shard"]) == 1
    err = capsys.readouterr().err
    assert "not yet ported" not in err
    assert "partial multi-process wiring: missing PAINTFE_NUM_PROCESSES, " \
        "PAINTFE_PROCESS_ID" in err
    assert not (inputs / "o" / "in0.png").exists()


def test_profile_prints_stage_times(inputs, capsys):
    assert tcli.main(["-i", str(inputs / "in0.png"), "-s", str(inputs / "fx.rhai"),
                      "--output-dir", str(inputs / "o"), "--device", "cpu",
                      "--profile", "-v"]) == 0
    out = capsys.readouterr().out
    for stage in ("load:", "script:", "encode:", "[script] done"):
        assert stage in out
    assert "flatten:" not in out  # a one-layer image skips the compositor


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


# -- layered documents (.pfe in, flatten, PNG / .pfe out) ---------------------

LAYERED = "apply_blur(2.0); rotate_canvas_180(); flip_canvas_horizontal();"


def _write_documents(d):
    """A V1 document (raster layers, one hidden) and a V3 one (adjustment
    layers, a hidden folder, empty 64 px tiles), written by the JAX
    package's save_pfe."""
    from paintfe_tpu.core import canvas as jcanvas
    from paintfe_tpu.core import deep as jdeep
    from paintfe_tpu.io import pfe as jpfe

    rng = np.random.default_rng(77)
    h, w = 70, 96

    def raster(name, mode, opacity, folder=None):
        layer = jcanvas.Layer.new(name, w, h)
        px = rng.integers(0, 256, (h, w, 4), np.uint8)
        px[:64, 64:] = 0  # an empty tile in every raster layer
        layer.pixels = jcanvas.canonicalize_tiles(px)
        layer.blend_mode, layer.opacity, layer.folder_id = mode, opacity, folder
        return layer

    def adjustment(name, opacity, **kw):
        layer = jcanvas.Layer.new(name, w, h)
        layer.content = "adjustment"
        layer.adjustment = jdeep.AdjustmentLayerData(**kw)
        layer.opacity = opacity
        return layer

    v1 = jcanvas.Canvas(width=w, height=h)
    v1.layers = [raster("bg", 0, 1.0), raster("mul", 1, 0.7), raster("off", 2, 1.0),
                 raster("soft", 16, 0.8)]
    v1.layers[2].visible = False
    v1.active_layer_index = 1
    jpfe.save_pfe(v1, str(d / "v1doc.pfe"))

    v3 = jcanvas.Canvas(width=w, height=h)
    v3.folders = [jcanvas.LayerFolder(id=1, name="hidden", visible=False)]
    v3.layers = [raster("bg", 0, 1.0), raster("mul", 1, 0.7), raster("soft", 16, 1.0),
                 adjustment("bc", 0.6, kind=1, brightness=10.0, contrast=25.0),
                 raster("screen", 2, 1.0), raster("ghost", 9, 1.0, folder=1),
                 adjustment("inv", 0.3, kind=2)]
    v3.active_layer_index = 2
    jpfe.save_pfe(v3, str(d / "v3doc.pfe"))
    return ["v1doc", "v3doc"]


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("fmt", ["png", "pfe"])
@pytest.mark.parametrize("script", [LAYERED, "apply_median(1); rotate_canvas_90cw();"])
def test_layered_documents_match_jax_cli(inputs, shard, fmt, script):
    """V1 and V3 documents (adjustment layers, a hidden folder) through both
    CLIs, serially and with --shard, to PNG and to .pfe: the same bytes."""
    names = _write_documents(inputs)
    (inputs / "doc.rhai").write_text(script)
    common = ["-i", str(inputs / "*.pfe"), str(inputs / "in2.png"),
              "-s", str(inputs / "doc.rhai"), "-f", fmt]
    extra = ["--shard"] if shard else []
    jrc = jcli.main(common + ["--output-dir", str(inputs / "jax"), *extra])
    trc = tcli.main(common + ["--output-dir", str(inputs / "port"), "--device", "cpu", *extra])
    assert trc == jrc == 0
    ref = sorted(p.name for p in (inputs / "jax").iterdir())
    assert sorted(p.name for p in (inputs / "port").iterdir()) == ref
    assert {f"{n}.{fmt}" for n in names} <= set(ref)
    for name in ref:
        assert (inputs / "port" / name).read_bytes() == (inputs / "jax" / name).read_bytes(), name


def test_no_flatten_writes_the_active_layer(inputs):
    _write_documents(inputs)
    common = ["-i", str(inputs / "v3doc.pfe"), "-s", str(inputs / "fx.rhai"),
              "--no-flatten", "-f", "png"]
    assert jcli.main(common + ["--output-dir", str(inputs / "jax")]) == 0
    assert tcli.main(common + ["--output-dir", str(inputs / "port"), "--device", "cpu"]) == 0
    assert ((inputs / "port" / "v3doc.png").read_bytes()
            == (inputs / "jax" / "v3doc.png").read_bytes())


def test_layered_profile_times_the_flatten(inputs, capsys):
    _write_documents(inputs)
    assert tcli.main(["-i", str(inputs / "v3doc.pfe"), "-s", str(inputs / "fx.rhai"),
                      "--output-dir", str(inputs / "o"), "--device", "cpu",
                      "--profile"]) == 0
    out = capsys.readouterr().out
    for stage in ("load:", "script:", "flatten:", "encode:"):
        assert stage in out


def _stage_names(out):
    """The stage names of --profile's report lines ("  load: 1.2 ms")."""
    import re

    return re.findall(r"^  (\w+): [0-9.]+ ms$", out, flags=re.M)


@pytest.mark.parametrize("source,fmt", [("v3doc.pfe", "pfe"), ("v1doc.pfe", "pfe"),
                                        ("v3doc.pfe", "png"), ("in0.png", "pfe")])
def test_profile_stages_match_the_jax_cli(inputs, capsys, source, fmt):
    """--profile prints the stages the JAX CLI prints, in its order: -f pfe
    times no stage around save_pfe (no "encode"), a flattened document
    times flatten and encode."""
    _write_documents(inputs)
    common = ["-i", str(inputs / source), "-s", str(inputs / "fx.rhai"), "-f", fmt,
              "--profile"]
    assert jcli.main(common + ["--output-dir", str(inputs / "jax")]) == 0
    want = _stage_names(capsys.readouterr().out)
    assert tcli.main(common + ["--output-dir", str(inputs / "port"), "--device", "cpu"]) == 0
    got = _stage_names(capsys.readouterr().out)
    assert got == want
    assert ("encode" in got) == (fmt != "pfe")
    assert got[:2] == ["load", "script"]


@pytest.mark.parametrize("shard", [False, True])
def test_text_layers_and_pdn_report_not_yet_ported(inputs, capsys, shard, monkeypatch):
    """Text layers and .pdn documents, once refused, now run through both
    CLIs to the same bytes; a malformed RAW input fails as a decode error
    (RAW is ported) beside an input that succeeds, and a multi-host launch
    wired by PAINTFE_COORDINATOR alone is refused as partial wiring."""
    import chip_smoke
    from paintfe_tpu.core import canvas as jcanvas
    from paintfe_tpu.io import pfe as jpfe
    from paintfe_tpu.ops.text_layer import make_text_layer_data

    doc = jcanvas.Canvas.new(20, 10)
    doc.layers.append(jcanvas.Layer.new("words", 20, 10))
    doc.layers[1].content = "text"
    doc.layers[1].text_data = make_text_layer_data("Hi", 1, 0, size=9)
    jpfe.save_pfe(doc, str(inputs / "text.pfe"))
    rng = np.random.default_rng(3)
    (inputs / "doc.pdn").write_bytes(chip_smoke.pdn_bytes(
        [dict(name="a", pixels=rng.integers(0, 256, (10, 20, 4), np.uint8)),
         dict(name="b", pixels=rng.integers(0, 256, (10, 20, 4), np.uint8), blend="Screen")],
        20, 10))
    extra = ["--shard"] if shard else []
    common = ["-i", str(inputs / "text.pfe"), str(inputs / "doc.pdn"), str(inputs / "in0.png"),
              *extra]
    assert tcli.main(common + ["--output-dir", str(inputs / "o"), "--device", "cpu"]) == 0
    assert "not yet ported" not in capsys.readouterr().err
    assert jcli.main(common + ["--output-dir", str(inputs / "j")]) == 0
    for name in ("text.png", "doc.png", "in0.png"):
        assert (inputs / "o" / name).read_bytes() == (inputs / "j" / name).read_bytes(), name

    (inputs / "shot.dng").write_bytes(b"II*\0" + b"\0" * 12)
    argv = ["-i", str(inputs / "shot.dng"), str(inputs / "in0.png"),
            "--output-dir", str(inputs / "r"), "--device", "cpu", *extra]
    assert tcli.main(argv) == 1
    err = capsys.readouterr().err
    assert "failed to decode DNG" in err and "not yet ported" not in err
    assert (inputs / "r" / "in0.png").exists()
    monkeypatch.setenv("PAINTFE_COORDINATOR", "localhost:1234")
    assert tcli.main(argv) == 1
    err = capsys.readouterr().err
    assert "partial multi-process wiring" in err and "not yet ported" not in err
