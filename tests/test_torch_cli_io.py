"""The port's CLI and I/O (paintfe_tpu_torch.cli, io.codecs, io.pfe,
io.pdn, parallel.batch) on the cases of tests/test_cli_io.py: each file
the port writes equals the JAX package's byte for byte, each file it reads
gives the JAX package's pixels, and each CLI run (with --device cpu) has
the JAX CLI's exit code and output files.  The JAX file's .pdn cases need
the reference's fixture; here they run on a document of the same layout
(800x600, a red Normal background under a green Additive layer at opacity
161) written by chip_smoke.pdn_bytes."""

import numpy as np
import pytest

import chip_smoke
from paintfe_tpu import cli as jcli
from paintfe_tpu.core import fixtures as jfix
from paintfe_tpu.io import codecs as jcodecs
from paintfe_tpu.io import deep_export as jde
from paintfe_tpu.io import pdn as jpdn
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch.core import fixtures as tfix
from paintfe_tpu_torch.core.blend import BlendMode
from paintfe_tpu_torch.core.canvas import Canvas, Layer
from paintfe_tpu_torch.io import codecs as tcodecs
from paintfe_tpu_torch.io import deep_export as tde
from paintfe_tpu_torch.io import pdn as tpdn
from paintfe_tpu_torch.io import pfe as tpfe

from common import assert_golden, golden_path, load_png


def gradient(w, h):
    img = tfix.test_gradient(w, h)
    np.testing.assert_array_equal(img, jfix.test_gradient(w, h))
    return img


def cli(pkg, argv):
    """`pkg`'s CLI exit code for `argv` (the port's with --device cpu)."""
    if pkg is tcli:
        return tcli.main(list(argv) + ["--device", "cpu"])
    return jcli.main(list(argv))


def save_both(tmp_path, img, name, fmt, **kw):
    """`img` saved by each package's codecs; the files must be the same
    bytes.  Returns the port's path."""
    (tmp_path / "j").mkdir(exist_ok=True)
    (tmp_path / "t").mkdir(exist_ok=True)
    jcodecs.save_image(img, tmp_path / "j" / name, fmt, **kw)
    tcodecs.save_image(img, tmp_path / "t" / name, fmt, **kw)
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    return tmp_path / "t" / name


def load_both(path):
    out = tcodecs.load_image(path, device="cpu")
    np.testing.assert_array_equal(out, jcodecs.load_image(path))
    return out


def test_png_roundtrip(tmp_path):
    img = gradient(64, 64)
    np.testing.assert_array_equal(load_both(save_both(tmp_path, img, "x.png", "png")), img)


@pytest.mark.parametrize("fmt,tol", [("png", 0), ("bmp", 0), ("tga", 0),
                                     ("tiff", 0), ("webp", 0), ("jpeg", 26)])
def test_format_roundtrip(tmp_path, fmt, tol):
    img = gradient(64, 64)
    ext = tcodecs.format_extension(fmt)
    assert ext == jcodecs.format_extension(fmt)
    back = load_both(save_both(tmp_path, img, f"x.{ext}", fmt))
    if fmt in ("jpeg", "bmp"):
        img = img.copy()
        img[..., 3] = 255  # formats without alpha
    d = np.abs(back.astype(int) - img.astype(int))
    if fmt in ("jpeg", "bmp"):
        d = d[..., :3]
    assert d.max() <= tol


@pytest.mark.parametrize("mode", ["none", "lzw", "deflate"])
def test_tiff_compression_modes(tmp_path, mode):
    img = gradient(64, 64)
    p = save_both(tmp_path, img, f"t_{mode}.tiff", "tiff", tiff_compression=mode)
    np.testing.assert_array_equal(load_both(p), img)


@pytest.mark.parametrize("fmt,name,fps,colors", [
    ("gif", "anim.gif", 10, [(255, 0, 0, 255), (0, 255, 0, 255)]),
    ("apng", "anim.png", 5, [(255, 0, 0, 255), (0, 0, 255, 255)]),
])
def test_animation_roundtrip(tmp_path, fmt, name, fps, colors):
    size = 16 if fmt == "gif" else 8
    frames = [tfix.solid(size, size, c) for c in colors]
    for c, f in zip(colors, frames):
        np.testing.assert_array_equal(f, jfix.solid(size, size, c))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jcodecs.save_animation(frames, tmp_path / "j" / name, fmt, fps=fps)
    tcodecs.save_animation(frames, tmp_path / "t" / name, fmt, fps=fps)
    p = tmp_path / "t" / name
    assert p.read_bytes() == (tmp_path / "j" / name).read_bytes()
    back, delays = tcodecs.load_frames(p)
    jback, jdelays = jcodecs.load_frames(p)
    assert delays == jdelays
    assert len(back) == len(jback) == 2
    for a, b in zip(back, jback):
        np.testing.assert_array_equal(a, b)
    assert tcodecs.detect_animation(p) == jcodecs.detect_animation(p) is True
    if fmt == "gif":
        assert delays[0] == 100  # 10 fps -> 10cs -> 100ms
    else:
        np.testing.assert_array_equal(back[1], frames[1])


def canvas_of(canvas_cls, layer_cls, blend, img, top=None):
    c = canvas_cls.from_image(img)
    if top is not None:
        t = layer_cls(name="top", pixels=top)
        t.blend_mode = blend.MULTIPLY
        t.opacity = 0.7
        c.layers.append(t)
    return c


def pfe_both(tmp_path, img, top=None):
    """One document saved by each package's save_pfe (the same bytes) and
    read back by each load_pfe (the same layers); the port's canvas."""
    from paintfe_tpu.core.blend import BlendMode as JBlend
    from paintfe_tpu.core.canvas import Canvas as JCanvas, Layer as JLayer

    tc = canvas_of(Canvas, Layer, BlendMode, img, top)
    jc = canvas_of(JCanvas, JLayer, JBlend, img, top)
    tpfe.save_pfe(tc, str(tmp_path / "t.pfe"))
    jpfe.save_pfe(jc, str(tmp_path / "j.pfe"))
    assert (tmp_path / "t.pfe").read_bytes() == (tmp_path / "j.pfe").read_bytes()
    back = tpfe.load_pfe(str(tmp_path / "t.pfe"))
    jback = jpfe.load_pfe(str(tmp_path / "t.pfe"))
    assert (back.width, back.height, len(back.layers)) == (jback.width, jback.height,
                                                           len(jback.layers))
    for a, b in zip(back.layers, jback.layers):
        assert (a.name, int(a.blend_mode), a.opacity, a.visible) == (
            b.name, int(b.blend_mode), b.opacity, b.visible)
        np.testing.assert_array_equal(a.pixels, np.asarray(b.pixels))
    return tc, back


def test_pfe_multilayer_roundtrip(tmp_path):
    board = tfix.test_checkerboard(70, 50)
    fg = tfix.blend_test_foreground(70, 50)
    np.testing.assert_array_equal(board, jfix.test_checkerboard(70, 50))
    np.testing.assert_array_equal(fg, jfix.blend_test_foreground(70, 50))
    canvas, back = pfe_both(tmp_path, board, fg)
    assert back.width == 70 and back.height == 50
    assert len(back.layers) == 2
    assert back.layers[1].blend_mode == BlendMode.MULTIPLY
    assert abs(back.layers[1].opacity - 0.7) < 1e-6
    np.testing.assert_array_equal(back.layers[0].pixels, canvas.layers[0].pixels)
    np.testing.assert_array_equal(back.layers[1].pixels, canvas.layers[1].pixels)


def test_pfe_sparse_chunks(tmp_path):
    img = np.zeros((128, 128, 4), np.uint8)
    img[0:10, 0:10] = [255, 0, 0, 255]
    _, back = pfe_both(tmp_path, img)
    np.testing.assert_array_equal(back.layers[0].pixels, img)


# -- CLI ---------------------------------------------------------------------


def png_in(path, img):
    path.parent.mkdir(parents=True, exist_ok=True)
    tcodecs.save_image(img, path, "png")
    return path


def same_files(port_paths, jax_paths):
    for t, j in zip(port_paths, jax_paths):
        assert t.read_bytes() == j.read_bytes(), t.name


def test_cli_convert(tmp_path):
    src = png_in(tmp_path / "in.png", gradient(32, 32))
    assert cli(jcli, ["-i", str(src), "-o", str(tmp_path / "j.jpg")]) == 0
    assert cli(tcli, ["-i", str(src), "-o", str(tmp_path / "t.jpg")]) == 0
    same_files([tmp_path / "t.jpg"], [tmp_path / "j.jpg"])


@pytest.mark.parametrize("name,script", [
    ("apply_desaturate", "apply_desaturate();"),
    ("apply_brightness_contrast", "apply_brightness_contrast(20.0, 10.0);"),
])
def test_cli_script_matches_goldens(tmp_path, name, script):
    """The desaturate and brightness/contrast slice through both CLIs: the
    same PNG, held to the reference golden where the golden tree is
    mounted."""
    src = png_in(tmp_path / "in.png", gradient(64, 64))
    (tmp_path / "s.rhai").write_text(script)
    for pkg, out in ((jcli, "j.png"), (tcli, "t.png")):
        assert cli(pkg, ["-i", str(src), "-s", str(tmp_path / "s.rhai"),
                         "-o", str(tmp_path / out)]) == 0
    same_files([tmp_path / "t.png"], [tmp_path / "j.png"])
    if golden_path("scripting", name).exists():
        assert_golden("scripting", name, load_png(tmp_path / "t.png"))


def test_cli_batch_glob_keep_going(tmp_path):
    png_in(tmp_path / "in" / "a.png", gradient(16, 16))
    png_in(tmp_path / "in" / "b.png", gradient(16, 16))
    (tmp_path / "in" / "c.png").write_bytes(b"not a png")
    for pkg, out in ((jcli, "j"), (tcli, "t")):
        assert cli(pkg, ["-i", str(tmp_path / "in" / "*.png"),
                         "--output-dir", str(tmp_path / out), "-f", "png"]) == 1
    same_files([tmp_path / "t" / "a.png", tmp_path / "t" / "b.png"],
               [tmp_path / "j" / "a.png", tmp_path / "j" / "b.png"])
    assert not (tmp_path / "t" / "c.png").exists()


def test_cli_multi_input_requires_output_dir(tmp_path, capsys):
    a = png_in(tmp_path / "a.png", gradient(8, 8))
    b = png_in(tmp_path / "b.png", gradient(8, 8))
    argv = ["-i", str(a), str(b), "-o", str(tmp_path / "x.png")]
    assert cli(jcli, argv) == 1
    jerr = capsys.readouterr().err
    assert cli(tcli, argv) == 1
    assert capsys.readouterr().err == jerr
    assert not (tmp_path / "x.png").exists()


def test_cli_collision_safe_output(tmp_path):
    for pkg, d in ((jcli, "j"), (tcli, "t")):
        src = png_in(tmp_path / d / "img.png", gradient(8, 8))
        assert cli(pkg, ["-i", str(src), "-f", "png"]) == 0
    same_files([tmp_path / "t" / "img_out.png"], [tmp_path / "j" / "img_out.png"])


def test_cli_canvas_op_resize(tmp_path):
    src = png_in(tmp_path / "in.png", gradient(64, 64))
    (tmp_path / "s.rhai").write_text('resize_image(32, 32, "bilinear");')
    for pkg, out in ((jcli, "j.png"), (tcli, "t.png")):
        assert cli(pkg, ["-i", str(src), "-s", str(tmp_path / "s.rhai"),
                         "-o", str(tmp_path / out)]) == 0
    same_files([tmp_path / "t.png"], [tmp_path / "j.png"])
    assert load_png(tmp_path / "t.png").shape == (32, 32, 4)


def test_cli_sharded_batch(tmp_path):
    for i in range(5):
        png_in(tmp_path / "in" / f"img{i}.png", gradient(32, 32))
    (tmp_path / "s.rhai").write_text("apply_invert();\napply_brightness_contrast(10.0, 5.0);")
    common = ["-i", str(tmp_path / "in" / "img*.png"), "-s", str(tmp_path / "s.rhai")]
    assert cli(tcli, common + ["--output-dir", str(tmp_path / "t_shard"), "--shard", "-v"]) == 0
    assert cli(tcli, common + ["--output-dir", str(tmp_path / "t_serial")]) == 0
    assert cli(jcli, common + ["--output-dir", str(tmp_path / "j_shard"), "--shard", "-v"]) == 0
    names = [f"img{i}.png" for i in range(5)]
    for d in ("t_serial", "j_shard"):
        same_files([tmp_path / "t_shard" / n for n in names], [tmp_path / d / n for n in names])


# -- .pdn documents, on a generated document of the reference fixture's layout --


def fixture_pdn(path):
    """800x600: "Background" (red, Normal, opacity 255) under "Layer 2"
    (green, Additive, opacity 161), as the reference's
    layers-opacity-additive.pdn."""
    h, w = 600, 800
    red = np.zeros((h, w, 4), np.uint8)
    red[...] = [255, 0, 0, 255]
    green = np.zeros((h, w, 4), np.uint8)
    green[...] = [0, 255, 0, 255]
    layers = [dict(name="Background", pixels=red, visible=True, opacity=255, blend="Normal"),
              dict(name="Layer 2", pixels=green, visible=True, opacity=161, blend="Additive")]
    path.write_bytes(chip_smoke.pdn_bytes(layers, w, h))
    return path


def test_pdn_native_decode_matches_reference_expectations(tmp_path):
    p = fixture_pdn(tmp_path / "fixture.pdn")
    c, j = tpdn.load_pdn(p), jpdn.load_pdn(p)
    assert (c.width, c.height, len(c.layers)) == (j.width, j.height, len(j.layers))
    for a, b in zip(c.layers, j.layers):
        assert (a.name, a.visible, a.opacity, int(a.blend_mode)) == (
            b.name, b.visible, b.opacity, int(b.blend_mode))
        np.testing.assert_array_equal(a.pixels, np.asarray(b.pixels))
    assert (c.width, c.height) == (800, 600)
    assert len(c.layers) == 2
    assert c.layers[0].name == "Background" and c.layers[0].visible
    assert c.layers[0].opacity == 1.0
    assert c.layers[0].blend_mode == BlendMode.NORMAL
    assert c.layers[1].name == "Layer 2" and c.layers[1].visible
    assert abs(c.layers[1].opacity - 161.0 / 255.0) < 1e-7
    assert c.layers[1].blend_mode == BlendMode.ADDITIVE
    np.testing.assert_array_equal(c.layers[0].pixels[0, 0], [255, 0, 0, 255])
    np.testing.assert_array_equal(c.layers[1].pixels[0, 0], [0, 255, 0, 255])


def test_pdn_malformed_rejected(tmp_path):
    bad = tmp_path / "bad.pdn"
    bad.write_bytes(b"not a Paint.NET project")
    with pytest.raises(tpdn.PdnError):
        tpdn.load_pdn(bad)
    with pytest.raises(jpdn.PdnError):
        jpdn.load_pdn(bad)


def test_cli_pdn_input_flattens(tmp_path):
    p = fixture_pdn(tmp_path / "fixture.pdn")
    for pkg, out in ((jcli, "j.png"), (tcli, "t.png")):
        assert cli(pkg, ["-i", str(p), "-o", str(tmp_path / out), "-f", "png"]) == 0
    same_files([tmp_path / "t.png"], [tmp_path / "j.png"])
    img = tcodecs.load_image(tmp_path / "t.png", device="cpu")
    assert img.shape == (600, 800, 4)
    assert img[0, 0, 0] == 255 and img[0, 0, 1] > 100


def test_cli_profile_prints_stage_timers(tmp_path, capsys):
    src = png_in(tmp_path / "p.png", gradient(16, 16))
    for pkg, out in ((jcli, "j.png"), (tcli, "t.png")):
        assert cli(pkg, ["-i", str(src), "-o", str(tmp_path / out), "--profile"]) == 0
        text = capsys.readouterr().out
        assert "load:" in text and "encode:" in text
    same_files([tmp_path / "t.png"], [tmp_path / "j.png"])


def test_pdn_truncated_deferred_payload_is_pdnerror(tmp_path):
    blob = fixture_pdn(tmp_path / "fixture.pdn").read_bytes()
    bad = tmp_path / "trunc.pdn"
    bad.write_bytes(blob[: len(blob) - 100])
    with pytest.raises(tpdn.PdnError):
        tpdn.load_pdn_native(bad)
    with pytest.raises(jpdn.PdnError):
        jpdn.load_pdn_native(bad)


def test_project_open_routes_pdn(tmp_path):
    from paintfe_tpu.core.project import Project as JProject
    from paintfe_tpu_torch.core.project import Project

    p = fixture_pdn(tmp_path / "fixture.pdn")
    proj, jproj = Project.open(p, device="cpu"), JProject.open(p)
    assert (proj.canvas.width, proj.canvas.height) == (800, 600)
    assert len(proj.canvas.layers) == len(jproj.canvas.layers) == 2
    for a, b in zip(proj.canvas.layers, jproj.canvas.layers):
        np.testing.assert_array_equal(a.pixels, np.asarray(b.pixels))


def test_cli_corrupt_pdn_keeps_going(tmp_path):
    good = png_in(tmp_path / "good.png", np.full((8, 8, 4), 50, np.uint8))
    bad = tmp_path / "bad.pdn"
    bad.write_bytes(b"PDN3" + b"\x00" * 64)
    for pkg, out in ((jcli, "j"), (tcli, "t")):
        assert cli(pkg, ["-i", str(bad), str(good), "--output-dir", str(tmp_path / out),
                         "-f", "png"]) == 1
    same_files([tmp_path / "t" / "good.png"], [tmp_path / "j" / "good.png"])
    assert not (tmp_path / "t" / "bad.png").exists()


def test_cli_script_resize_with_deep_input(tmp_path):
    u16 = np.random.default_rng(12).integers(0, 65536, (16, 16, 4), np.uint16)
    src = tmp_path / "deep.png"
    tde.write_png16(src, 16, 16, u16)
    jde.write_png16(tmp_path / "jdeep.png", 16, 16, u16)
    assert src.read_bytes() == (tmp_path / "jdeep.png").read_bytes()
    (tmp_path / "fx.rhai").write_text("resize_canvas(24, 24);")
    for pkg, out in ((jcli, "j"), (tcli, "t")):
        assert cli(pkg, ["-i", str(src), "-s", str(tmp_path / "fx.rhai"),
                         "--output-dir", str(tmp_path / out), "-f", "png"]) == 0
    same_files([tmp_path / "t" / "deep.png"], [tmp_path / "j" / "deep.png"])
    assert load_both(tmp_path / "t" / "deep.png").shape == (24, 24, 4)


def test_cli_animate_canonicalizes_like_single(tmp_path):
    """--animate commits script results as run_one does (transparent tiles
    canonicalized), in both CLIs."""
    img = np.zeros((64, 64, 4), np.uint8)
    img[..., 0] = 77  # alpha stays 0
    src = png_in(tmp_path / "t.png", img)
    (tmp_path / "fx.rhai").write_text("apply_brightness_contrast(1.0, 0.0);")
    fx = str(tmp_path / "fx.rhai")
    for pkg, tag in ((jcli, "j"), (tcli, "p")):
        assert cli(pkg, ["-i", str(src), "-s", fx, "-o", str(tmp_path / f"{tag}_single.png"),
                         "-f", "png"]) == 0
        assert cli(pkg, ["-i", str(src), "-s", fx, "--animate",
                         str(tmp_path / f"{tag}_anim.png"), "--fps", "5"]) == 0
    same_files([tmp_path / "p_single.png", tmp_path / "p_anim.png"],
               [tmp_path / "j_single.png", tmp_path / "j_anim.png"])
    frames, _delays = tcodecs.load_frames(tmp_path / "p_anim.png")
    single = tcodecs.load_image(tmp_path / "p_single.png", device="cpu")
    np.testing.assert_array_equal(frames[0][..., 3], single[..., 3])
