"""The port's text layers (paintfe_tpu_torch.ops.text_layer), its outline
(ops.effects.render) and the .pfe text payload against the JAX package's,
and the port's CLI on documents with text layers against the JAX CLI.
Text data is built once with the JAX package's classes and carried into
the port through the .pfe JSON payload; images are made from seeds with
numpy.  Tolerance 0 (bytes) throughout."""

import numpy as np
import pytest
import torch

from paintfe_tpu import cli as jcli
from paintfe_tpu.core import canvas as jcanvas
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu.ops import text_layer as jtl
from paintfe_tpu.ops.effects import render as jrender
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.io import pfe as tpfe
from paintfe_tpu_torch.ops import text_layer as ttl
from paintfe_tpu_torch.ops.effects import render as trender


def _port(jdata):
    """The same text data as the port's classes."""
    return ttl.text_data_from_json(jtl.text_data_to_json(jdata))


def _styled_runs():
    return [jtl.TextRun("Bold ", jtl.TextStyle(font_weight=700, font_size=18,
                                               color=(200, 30, 30, 255))),
            jtl.TextRun("ital ", jtl.TextStyle(italic=True, font_size=22, underline=True,
                                               color=(20, 90, 200, 230))),
            jtl.TextRun("mono\n", jtl.TextStyle(font_family="mono", font_size=15,
                                                strikethrough=True, letter_spacing=1.5)),
            jtl.TextRun("serif wide", jtl.TextStyle(font_family="serif", font_size=17,
                                                    width_scale=1.3, height_scale=0.8,
                                                    baseline_offset=2.0))]


def _case(name):
    if name == "empty":
        return jtl.TextLayerData()
    if name == "simple":
        return jtl.make_text_layer_data("Hello", 20, 20, size=24, color=(255, 0, 0, 255))
    td = jtl.TextLayerData()
    if name == "multi_block":
        td.add_block(jtl.TextBlock(position=(5.0, 10.0), runs=[jtl.TextRun("first block")],
                                   max_width=70.0,
                                   paragraph=jtl.ParagraphStyle(jtl.TextAlignment.CENTER)))
        td.add_block(jtl.TextBlock(position=(60.0, 70.0), rotation=0.3,
                                   runs=[jtl.TextRun("second, rotated")]))
        td.add_block(jtl.TextBlock(position=(10.0, 100.0), max_width=90.0,
                                   paragraph=jtl.ParagraphStyle(jtl.TextAlignment.RIGHT, 1.5),
                                   runs=[jtl.TextRun("right aligned and wrapped text")]))
        return td
    if name == "multi_run":
        td.add_block(jtl.TextBlock(position=(4.0, 8.0), runs=_styled_runs(), max_width=150.0))
        return td
    warps = {"arc": jtl.ArcWarp(bend=0.8), "arc_down": jtl.ArcWarp(bend=-0.5),
             "circular": jtl.CircularWarp(radius=60.0),
             "circular_ccw": jtl.CircularWarp(radius=45.0, start_angle_deg=30.0,
                                              clockwise=False),
             "path": jtl.PathFollowWarp(),
             "envelope": jtl.EnvelopeWarp(),
             "envelope_custom": jtl.EnvelopeWarp(top=(0.0, -30.0, 0.0),
                                                 bottom=(0.0, -10.0, 0.0))}
    td.add_block(jtl.TextBlock(position=(30.0, 100.0), warp=warps[name],
                               runs=[jtl.TextRun("WAVEFORM\nline two",
                                                 jtl.TextStyle(font_size=20))]))
    return td


CASES = ["empty", "simple", "multi_block", "multi_run", "arc", "arc_down", "circular",
         "circular_ccw", "path", "envelope", "envelope_custom"]


@pytest.mark.parametrize("name", CASES)
def test_rasterize_matches_jax(name):
    jdata = _case(name)
    tdata = _port(jdata)
    want = np.asarray(jdata.rasterize(200, 160))
    got = tdata.rasterize(200, 160, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert not tdata.needs_rasterize()
    assert (got[..., 3] > 0).any() == (name != "empty")


def _effects(kind):
    O, S = jtl.OutlineEffect, jtl.ShadowEffect
    pos = jtl.OutlinePosition
    return {
        "outline_outside": jtl.TextEffects(outline=O((255, 0, 0, 255), 2.0, pos.OUTSIDE)),
        "outline_inside": jtl.TextEffects(outline=O((0, 0, 255, 200), 3.0, pos.INSIDE)),
        "outline_center": jtl.TextEffects(outline=O((0, 160, 0, 255), 1.0, pos.CENTER)),
        "shadow": jtl.TextEffects(shadow=S((0, 0, 0, 160), 4.0, 4.0, 2.0, 0.0)),
        "shadow_spread_blur": jtl.TextEffects(shadow=S((20, 0, 60, 255), -3.0, 5.0, 2.5, 3.0)),
        "shadow_sharp": jtl.TextEffects(shadow=S((0, 0, 0, 255), 6.0, -2.0, 0.3, 1.0)),
        "outline_and_shadow": jtl.TextEffects(outline=O((255, 255, 0, 255), 2.0, pos.OUTSIDE),
                                              shadow=S((0, 0, 0, 180), 5.0, 5.0, 6.0, 1.5)),
    }[kind]


@pytest.mark.parametrize("kind", ["outline_outside", "outline_inside", "outline_center",
                                  "shadow", "shadow_spread_blur", "shadow_sharp",
                                  "outline_and_shadow"])
def test_effects_match_jax(kind):
    jdata = jtl.make_text_layer_data("FX ok", 30, 30, size=40, color=(255, 255, 255, 255))
    jdata.effects = _effects(kind)
    want = np.asarray(jdata.rasterize(180, 110))
    got = _port(jdata).rasterize(180, 110, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [1.0, 2.5, 4.0])
def test_disc_dilate_matches_jax(radius):
    mask = np.random.default_rng(3).random((30, 40)).astype(np.float32)
    mask[mask < 0.9] = 0.0
    np.testing.assert_array_equal(ttl._disc_dilate(mask, radius), jtl._disc_dilate(mask, radius))


def _alpha_image(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 3) ** 2
    img[..., 3] = np.where(blob, rng.integers(1, 256, (h, w)), 0).astype(np.uint8)
    img[2:5, 40:45, 3] = 255  # a small island
    return img


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("width,anti_alias", [(1, True), (2, True), (4, True), (3, False)])
def test_outline_matches_jax(mode, width, anti_alias):
    img = _alpha_image(width * 3 + mode)
    color = (250, 20, 90, 200)
    want = np.asarray(jrender.outline(img, width, color, jrender.OutlineMode(mode), anti_alias))
    got = trender.outline(img, width, color, trender.OutlineMode(mode), anti_alias,
                          device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_outline_masked_and_on_a_tensor_matches_jax():
    img = _alpha_image(9)
    mask = np.zeros(img.shape[:2], np.uint8)
    mask[:, 20:] = 255
    want = np.asarray(jrender.outline(img, 3, (0, 0, 0, 255), jrender.OutlineMode.CENTER,
                                      True, mask))
    got = trender.outline(torch.from_numpy(img), 3, (0, 0, 0, 255),
                          trender.OutlineMode.CENTER, True, mask, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    empty = np.zeros((8, 9, 4), np.uint8)
    np.testing.assert_array_equal(trender.outline(empty, 2, (1, 2, 3, 4), device="cpu").numpy(),
                                  empty)


def _text_doc(seed, w=120, h=80):
    rng = np.random.default_rng(seed)
    doc = jcanvas.Canvas.new(w, h)
    doc.layers[0].pixels = rng.integers(0, 256, (h, w, 4), np.uint8)
    text = jcanvas.Layer.new("caption ü", w, h)
    text.content = "text"
    text.text_data = jtl.make_text_layer_data("Caption", 8, 20, size=26,
                                              color=(255, 250, 240, 255))
    text.text_data.effects = _effects("outline_and_shadow")
    text.blend_mode = 2
    text.opacity = 0.9
    doc.layers.append(text)
    doc.active_layer_index = 0
    return doc


def _v3_text_doc(seed):
    from paintfe_tpu.core import deep as jdeep

    doc = _text_doc(seed)
    adj = jcanvas.Layer.new("bc", doc.width, doc.height)
    adj.content = "adjustment"
    adj.adjustment = jdeep.AdjustmentLayerData(kind=1, brightness=10.0, contrast=20.0)
    doc.layers.append(adj)
    return doc


@pytest.mark.parametrize("version", ["v2", "v3"])
def test_pfe_text_payload_round_trips(tmp_path, version):
    """The port reads the JAX package's text payload (V2 and V3 containers),
    writes the same bytes back, and the JAX package reads the port's."""
    doc = _text_doc(1) if version == "v2" else _v3_text_doc(2)
    jpfe.save_pfe(doc, str(tmp_path / "j.pfe"))
    tdoc = tpfe.load_pfe(str(tmp_path / "j.pfe"))
    jdoc = jpfe.load_pfe(str(tmp_path / "j.pfe"))
    assert ttl.text_data_to_json(tdoc.layers[1].text_data) == \
        jtl.text_data_to_json(jdoc.layers[1].text_data)
    tpfe.save_pfe(tdoc, str(tmp_path / "t.pfe"))
    assert (tmp_path / "t.pfe").read_bytes() == (tmp_path / "j.pfe").read_bytes()
    back = jpfe.load_pfe(str(tmp_path / "t.pfe"))
    assert jtl.text_data_to_json(back.layers[1].text_data) == \
        jtl.text_data_to_json(doc.layers[1].text_data)
    # the carried-across document writes the same bytes too
    tpfe.save_pfe(canvas_from_document(doc), str(tmp_path / "c.pfe"))
    assert (tmp_path / "c.pfe").read_bytes() == (tmp_path / "j.pfe").read_bytes()


def test_an_undecodable_text_payload_keeps_the_pixels(tmp_path):
    assert ttl.text_data_from_json(b"\x00\x01bincode") is None
    assert ttl.text_data_from_json(b'{"blocks": [{"warp": {"_warp": "twirl"}}]}') is None


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("fmt", ["png", "pfe"])
def test_cli_on_text_documents_matches_jax_cli(tmp_path, shard, fmt):
    jpfe.save_pfe(_text_doc(3), str(tmp_path / "t2.pfe"))
    jpfe.save_pfe(_v3_text_doc(4), str(tmp_path / "t3.pfe"))
    (tmp_path / "fx.rhai").write_text("apply_blur(1.0); rotate_canvas_180();")
    common = ["-i", str(tmp_path / "*.pfe"), "-s", str(tmp_path / "fx.rhai"), "-f", fmt]
    extra = ["--shard"] if shard else []
    assert jcli.main(common + ["--output-dir", str(tmp_path / "jax"), *extra]) == 0
    assert tcli.main(common + ["--output-dir", str(tmp_path / "port"), "--device", "cpu",
                               *extra]) == 0
    for name in ("t2", "t3"):
        assert ((tmp_path / "port" / f"{name}.{fmt}").read_bytes()
                == (tmp_path / "jax" / f"{name}.{fmt}").read_bytes()), name


def test_ensure_text_layers_rasterized_matches_jax():
    jdoc = _text_doc(5)
    tdoc = canvas_from_document(jdoc)
    jtl.ensure_text_layers_rasterized(jdoc)
    ttl.ensure_text_layers_rasterized(tdoc, device="cpu")
    np.testing.assert_array_equal(tdoc.layers[1].pixels, np.asarray(jdoc.layers[1].pixels))
    np.testing.assert_array_equal(tdoc.composite(device="cpu"), np.asarray(jdoc.composite()))


THREAD_ROUNDS = 48


def test_text_layers_rasterised_from_two_threads_match_serial():
    """Two different text layers rasterised from two threads at once share
    ops/text_layer._load_font's cached PIL fonts (the server's handler
    threads do so for text-layer jobs sent at once): each result, over
    THREAD_ROUNDS rounds of two rasterisations a thread started together,
    equals the same layer rasterised serially, byte for byte.  The switch
    interval is cut to interleave the threads as often as the interpreter
    lets them."""
    import sys
    import threading

    a = _port(_case("multi_run"))
    b = _port(_case("multi_block"))
    style = b.blocks[0].runs[0].style
    style.font_weight, style.font_size = 700, 18.0  # the cached face "multi_run" draws with
    assert ttl._load_font("default", 18, True, False) is ttl._load_font("default", 18, True,
                                                                        False)
    want = {"a": a.rasterize(200, 160, device="cpu"), "b": b.rasterize(200, 160, device="cpu")}
    got = {"a": [], "b": []}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(THREAD_ROUNDS):
            start = threading.Barrier(2)

            def run(key, data):
                start.wait(timeout=30)
                got[key] += [data.rasterize(200, 160, device="cpu") for _ in range(2)]

            threads = [threading.Thread(target=run, args=(k, d)) for k, d in (("a", a), ("b", b))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for key in ("a", "b"):
        assert len(got[key]) == 2 * THREAD_ROUNDS
        assert all(np.array_equal(g, want[key]) for g in got[key]), key
