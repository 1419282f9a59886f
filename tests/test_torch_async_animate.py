"""The port's execute_script_async, --animate (serial and --shard) and
--trace-dir against the JAX package's, on images made from seeds with
numpy; tolerance 0 (bytes) throughout."""

import json
import threading
import time

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from paintfe_tpu import cli as jcli
from paintfe_tpu.scripting import execute_script_async as jasync
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch.io import codecs as tcodecs
from paintfe_tpu_torch.scripting import ScriptError, ScriptMessage, execute_script_async


def _drain(q, timeout=30.0):
    out = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            msg = q.get(timeout=0.2)
        except Exception:
            continue
        out.append(msg)
        if msg.kind in ("completed", "error"):
            return out
    raise TimeoutError("no terminal message")


def _img(seed, h=24, w=32):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)


STREAMING = ('print_line("starting"); progress(0.25); apply_invert(); sleep(1); '
             'apply_blur(1.5); progress(0.75); print_line("done");')


def test_async_message_sequence_matches_jax():
    img = _img(1)
    jt, jq = jasync(STREAMING, img, 32, 24)
    tt, tq = execute_script_async(STREAMING, img, 32, 24, device="cpu")
    jmsgs, tmsgs = _drain(jq), _drain(tq)
    jt.join(5)
    tt.join(5)
    assert [m.kind for m in tmsgs] == [m.kind for m in jmsgs] == [
        "console", "progress", "preview", "progress", "console", "completed"]
    for j, t in zip(jmsgs[:-1], tmsgs[:-1]):
        if t.kind == "preview":
            np.testing.assert_array_equal(t.payload[0], np.asarray(j.payload[0]))
            assert t.payload[1:] == tuple(j.payload[1:])
        else:
            assert t.payload == j.payload
    tpx, tw, th, tcon, tops, tms = tmsgs[-1].payload
    jpx, jw, jh, jcon, jops, _ = jmsgs[-1].payload
    np.testing.assert_array_equal(tpx, np.asarray(jpx))
    assert (tw, th, tcon, len(tops)) == (jw, jh, jcon, len(jops))
    assert isinstance(tms, int) and tms >= 0
    assert isinstance(tmsgs[-1], ScriptMessage)


@pytest.mark.parametrize("source,match", [("let x = 1 / 0;", "zero"),
                                          ("let x = ;", ""),
                                          ("apply_pixelate(2.5);", "integer")])
def test_async_errors_match_jax(source, match):
    img = _img(2, 8, 8)
    jmsgs = _drain(jasync(source, img, 8, 8)[1])
    tmsgs = _drain(execute_script_async(source, img, 8, 8, device="cpu")[1])
    assert [m.kind for m in tmsgs] == [m.kind for m in jmsgs]
    assert tmsgs[-1].kind == "error" and isinstance(tmsgs[-1].payload, ScriptError)
    assert str(tmsgs[-1].payload) == str(jmsgs[-1].payload)
    assert match in str(tmsgs[-1].payload).lower()


def test_async_cancellation_matches_jax():
    img = _img(3, 8, 8)
    results = []
    for run in (jasync, execute_script_async):
        cancel = threading.Event()
        cancel.set()
        kw = {} if run is jasync else {"device": "cpu"}
        msgs = _drain(run("let i = 0; while true { i += 1; }", img, 8, 8,
                          cancel_event=cancel, **kw)[1])
        results.append((msgs[-1].kind, msgs[-1].payload.message))
    assert results[0] == results[1]
    assert results[1][0] == "error" and "cancel" in results[1][1].lower()


def test_async_refuses_a_missing_card_before_starting():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_script_async("apply_invert();", _img(4, 4, 4), 4, 4)


def test_async_workers_at_once_match_sync():
    """Two workers at once, different blurs and a twist: each result equals
    the synchronous engine's."""
    from paintfe_tpu_torch.scripting import execute_script_sync

    img = _img(5, 40, 44)
    scripts = ["apply_blur(1.0); apply_twist(30.0);", "apply_blur(3.0); apply_twist(-45.0);"]
    runs = [execute_script_async(s, img, 44, 40, device="cpu") for s in scripts]
    for (thread, q), s in zip(runs, scripts):
        msg = _drain(q)[-1]
        thread.join(5)
        assert msg.kind == "completed"
        np.testing.assert_array_equal(msg.payload[0],
                                      execute_script_sync(s, img, 44, 40, device="cpu")[0])


def _frames_dir(d, n=4, h=18, w=26):
    for i in range(n):
        img = _img(10 + i, h, w)
        img[0:6, 0:6] = [(i * 37) % 256, (i * 91) % 256, 40, 255]  # distinct frames
        Image.fromarray(img, "RGBA").save(d / f"f{i}.png")


def _layered_inputs(d, h=18, w=26):
    """A .pdn and a .pfe with a text layer of the frames' size."""
    from paintfe_tpu.core import canvas as jcanvas
    from paintfe_tpu.io import pfe as jpfe
    from paintfe_tpu.ops import text_layer as jtl

    layers = [dict(name="a", pixels=_img(30, h, w)),
              dict(name="b", pixels=_img(31, h, w), blend="Multiply", opacity=180)]
    (d / "g.pdn").write_bytes(chip_smoke.pdn_bytes(layers, w, h))
    doc = jcanvas.Canvas.new(w, h)
    doc.layers[0].pixels = _img(32, h, w)
    text = jcanvas.Layer.new("t", w, h)
    text.content = "text"
    text.text_data = jtl.make_text_layer_data("Ab", 2, 2, size=12, color=(255, 255, 0, 255))
    text.text_data.effects.shadow = jtl.ShadowEffect(blur_radius=1.5)
    doc.layers.append(text)
    jpfe.save_pfe(doc, str(d / "h.pfe"))


@pytest.mark.parametrize("ext", ["png", "gif", "webp"])
@pytest.mark.parametrize("layered", [False, True])
def test_animate_matches_jax_cli(tmp_path, ext, layered):
    """--animate to APNG, GIF and lossless WebP: the port's frames (through
    load_frames) and file bytes equal the JAX CLI's."""
    _frames_dir(tmp_path)
    if layered:
        _layered_inputs(tmp_path)
    (tmp_path / "fx.rhai").write_text("apply_blur(1.0); apply_sepia(0.4);")
    inputs = [str(tmp_path / "f*.png")] + ([str(tmp_path / "g.pdn"), str(tmp_path / "h.pfe")]
                                           if layered else [])
    common = ["-i", *inputs, "-s", str(tmp_path / "fx.rhai"), "--fps", "12"]
    assert jcli.main(common + ["--animate", str(tmp_path / f"j.{ext}")]) == 0
    assert tcli.main(common + ["--animate", str(tmp_path / f"t.{ext}"), "--device", "cpu"]) == 0
    jframes, jdelays = tcodecs.load_frames(tmp_path / f"j.{ext}")
    tframes, tdelays = tcodecs.load_frames(tmp_path / f"t.{ext}")
    assert len(tframes) == len(jframes) == (6 if layered else 4)
    assert tdelays == jdelays
    for a, b in zip(tframes, jframes):
        np.testing.assert_array_equal(a, b)
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


def test_sharded_animate_equals_serial_and_keeps_going(tmp_path, capsys):
    """--shard --animate over a bucket and layered documents: the same
    file as the serial run; a corrupt member drops its frame, rc 1, the
    other frames in order."""
    _frames_dir(tmp_path, n=5)
    _layered_inputs(tmp_path)
    (tmp_path / "fx.rhai").write_text("apply_brightness_contrast(12.0, 18.0); apply_sepia(0.4);")
    inputs = [str(tmp_path / "f*.png"), str(tmp_path / "g.pdn"), str(tmp_path / "h.pfe")]
    common = ["-i", *inputs, "-s", str(tmp_path / "fx.rhai"), "--device", "cpu"]
    assert tcli.main(common + ["--animate", str(tmp_path / "serial.gif")]) == 0
    assert tcli.main(common + ["--shard", "--animate", str(tmp_path / "shard.gif")]) == 0
    assert (tmp_path / "serial.gif").read_bytes() == (tmp_path / "shard.gif").read_bytes()
    frames, _ = tcodecs.load_frames(tmp_path / "shard.gif")
    assert len(frames) == 7
    (tmp_path / "f2a.png").write_bytes(b"not a png")
    assert tcli.main(common + ["--shard", "--animate", str(tmp_path / "broken.gif")]) == 1
    assert "error" in capsys.readouterr().err
    broken, _ = tcodecs.load_frames(tmp_path / "broken.gif")
    assert len(broken) == 7
    for a, b in zip(frames, broken):
        np.testing.assert_array_equal(a, b)


def test_sharded_animate_per_pixel_fallback(tmp_path):
    """A script the tracer cannot batch animates per image under --shard,
    identical to serial and to the JAX CLI."""
    _frames_dir(tmp_path, n=3, h=12, w=16)
    (tmp_path / "fx.rhai").write_text("for_each_pixel(|x, y, r, g, b, a| [b, g, r, a]);")
    common = ["-i", str(tmp_path / "f*.png"), "-s", str(tmp_path / "fx.rhai")]
    assert jcli.main(common + ["--animate", str(tmp_path / "j.gif")]) == 0
    for mode in ([], ["--shard"]):
        out = tmp_path / f"t{len(mode)}.gif"
        assert tcli.main(common + ["--animate", str(out), "--device", "cpu", *mode]) == 0
        assert out.read_bytes() == (tmp_path / "j.gif").read_bytes()


def test_animate_refuses_other_extensions(tmp_path, capsys):
    _frames_dir(tmp_path, n=1)
    assert tcli.main(["-i", str(tmp_path / "f0.png"), "--animate", str(tmp_path / "a.bmp"),
                      "--device", "cpu"]) == 1
    assert "--animate needs a .gif/.png/.webp path" in capsys.readouterr().err


def _trace_events(d):
    files = sorted(d.glob("*.json"))
    assert files, "no trace written"
    return [e for f in files for e in json.loads(f.read_text())["traceEvents"]]


def test_trace_dir_writes_a_trace(tmp_path):
    _frames_dir(tmp_path, n=2)
    (tmp_path / "fx.rhai").write_text("apply_blur(2.0);")
    assert tcli.main(["-i", str(tmp_path / "f*.png"), "-s", str(tmp_path / "fx.rhai"),
                      "--output-dir", str(tmp_path / "o"), "--device", "cpu",
                      "--trace-dir", str(tmp_path / "tr")]) == 0
    assert _trace_events(tmp_path / "tr")
    assert len(list((tmp_path / "o").glob("*.png"))) == 2


def test_trace_dir_keeps_the_trace_when_a_script_fails(tmp_path, capsys):
    _frames_dir(tmp_path, n=1)
    (tmp_path / "bad.rhai").write_text("let x = 1 / 0;")
    assert tcli.main(["-i", str(tmp_path / "f0.png"), "-s", str(tmp_path / "bad.rhai"),
                      "--output-dir", str(tmp_path / "o"), "--device", "cpu",
                      "--trace-dir", str(tmp_path / "tr")]) == 1
    assert "script error" in capsys.readouterr().err
    assert _trace_events(tmp_path / "tr")


def test_trace_dir_is_finalized_when_an_exception_escapes(tmp_path, monkeypatch):
    _frames_dir(tmp_path, n=1)

    def boom(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli, "run_one", boom)
    with pytest.raises(KeyboardInterrupt):
        tcli.main(["-i", str(tmp_path / "f0.png"), "--output-dir", str(tmp_path / "o"),
                   "--device", "cpu", "--trace-dir", str(tmp_path / "tr")])
    assert _trace_events(tmp_path / "tr")


def test_no_trace_without_trace_dir(tmp_path):
    _frames_dir(tmp_path, n=1)
    assert tcli.main(["-i", str(tmp_path / "f0.png"), "--output-dir", str(tmp_path / "o"),
                      "--device", "cpu"]) == 0
    assert not list(tmp_path.rglob("*.json"))
