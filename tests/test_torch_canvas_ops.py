"""The port's layer and mask operations and clipboard
(paintfe_tpu_torch.ops.{canvas_ops,clipboard}) against the JAX package's:
merge down over every blend mode (on K-composite's plain version here),
merge down as mask, channels, the layer-mask lifecycle, layer CRUD,
flatten, alignment, and copy / cut / paste with the OS bridge stubbed.
The same seeded inputs, device "cpu", tolerance 0."""

import os
import tempfile

import numpy as np
import pytest

import chip_smoke
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu.ops import canvas_ops as jco
from paintfe_tpu.ops import clipboard as jclip
from paintfe_tpu_torch.core.blend import BlendMode
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.core.selection import feather, rect_mask
from paintfe_tpu_torch.io.pfe import load_pfe, save_pfe
from paintfe_tpu_torch.ops import canvas_ops as tco
from paintfe_tpu_torch.ops import clipboard as tclip

H, W = 72, 96


def _pair(seed=1, n_layers=4):
    """chip_smoke's editing document in both packages, each through its
    own .pfe loader."""
    doc = chip_smoke.editing_document(np.random.default_rng(seed), H, W, n_layers)
    with tempfile.TemporaryDirectory() as d:
        save_pfe(doc, f"{d}/doc.pfe")
        return load_pfe(f"{d}/doc.pfe"), jpfe.load_pfe(f"{d}/doc.pfe")


def _same(t, j):
    return chip_smoke.document_differences(t, canvas_from_document(j)) == []


@pytest.mark.parametrize("mode", list(BlendMode))
@pytest.mark.parametrize("opacity", [0.0, 0.37, 1.0])
def test_merge_down_equals_jax(mode, opacity):
    t, j = _pair()
    for doc in (t, j):
        doc.layers[2].blend_mode = type(doc.layers[2].blend_mode)(int(mode))
        doc.layers[2].opacity = opacity
    before = t.layers[1].pixels
    tco.merge_down(t, 2, device="cpu")
    jco.merge_down(j, 2)
    assert _same(t, j) and len(t.layers) == 3
    assert t.layers[1].pixels is not before


@pytest.mark.parametrize("idx", [0, 1, 3, 9])
@pytest.mark.parametrize("visible", [True, False])
def test_merge_down_edges_equal_jax(idx, visible):
    t, j = _pair(2)
    for doc in (t, j):
        doc.layers[min(idx, 3)].visible = visible
        doc.active_layer_index = 3
    tco.merge_down(t, idx, device="cpu")
    jco.merge_down(j, idx)
    assert _same(t, j)


@pytest.mark.parametrize("idx", [0, 1, 2, 7])
def test_merge_down_as_mask_equals_jax(idx):
    t, j = _pair(3)
    tco.merge_down_as_mask(t, idx)
    jco.merge_down_as_mask(j, idx)
    assert _same(t, j)


@pytest.mark.parametrize("channel", list(tco.ImageChannel))
def test_extract_channel_equals_jax(channel):
    t, j = _pair(4)
    tco.extract_channel_to_layer(t, 2, channel)
    jco.extract_channel_to_layer(j, 2, jco.ImageChannel(channel.value))
    assert _same(t, j)


@pytest.mark.parametrize("target", list(tco.ImageChannel))
@pytest.mark.parametrize("source", [tco.ImageChannel.GREEN, tco.ImageChannel.LUMINANCE])
def test_replace_channel_equals_jax(target, source):
    t, j = _pair(5)
    tco.replace_channel_from_layer(t, 0, 2, target, source)
    jco.replace_channel_from_layer(j, 0, 2, jco.ImageChannel(target.value),
                                   jco.ImageChannel(source.value))
    assert _same(t, j)


MASK_SEQUENCES = [
    ["reveal_all", "invert", "apply"],
    ["from_selection", "invert", "toggle", "toggle", "apply"],
    ["from_selection", "from_selection", "delete", "invert"],
    ["select_none", "from_selection", "invert", "apply"],
    ["reveal_all", "toggle", "reveal_all", "delete", "apply"],
]


@pytest.mark.parametrize("seq", MASK_SEQUENCES, ids=lambda s: "-".join(s))
def test_layer_mask_lifecycle_equals_jax(seq):
    t, j = _pair(6)
    sel = feather(rect_mask(W, H, 10, 5, 60, 50), 3.0)
    for doc, m in ((t, tco), (j, jco)):
        doc.selection = sel.copy()
        for op in seq:
            if op == "select_none":
                doc.selection = None
            elif op == "reveal_all":
                m.add_layer_mask_reveal_all(doc, 2)
            elif op == "from_selection":
                m.add_layer_mask_from_selection(doc, 2)
            else:
                getattr(m, f"{op}_layer_mask")(doc, 2)
    assert _same(t, j)


def test_layer_crud_equals_jax():
    t, j = _pair(7)
    for doc, m in ((t, tco), (j, jco)):
        assert m.add_layer(doc) == 3
        assert m.add_layer(doc, "named") == 4
        assert m.duplicate_layer(doc, 1) == 2
        assert m.duplicate_layer(doc) == 3
        m.move_layer(doc, 0, 4)
        m.delete_layer(doc, 2)
        m.delete_layer(doc)
        doc.active_layer_index = len(doc.layers) - 1
        m.delete_layer(doc)
        m.delete_layer(doc, 99)
    assert _same(t, j)


@pytest.mark.parametrize("seed", range(3))
def test_flatten_equals_jax(seed):
    t, j = _pair(8 + seed)
    for doc in (t, j):
        doc.layers[1].mask = np.random.default_rng(seed).integers(0, 256, (H, W), np.uint8)
        doc.layers[2].visible = seed != 1
    tco.flatten(t, device="cpu")
    jco.flatten(j)
    assert _same(t, j) and len(t.layers) == 1


def test_nontransparent_bounds_and_translate_equal_jax():
    img = np.zeros((H, W, 4), np.uint8)
    assert tco.nontransparent_bounds(img) is None is jco.nontransparent_bounds(img)
    img[10:30, 20:77] = 200
    img[40, 3, 3] = 1
    assert tco.nontransparent_bounds(img) == jco.nontransparent_bounds(img)
    for d in ((0, 0), (5, -7), (-30, 12), (200, 3), (-4, -100)):
        assert np.array_equal(tco.translate_image_clipped(img, *d),
                              jco.translate_image_clipped(img, *d))


@pytest.mark.parametrize("ax", [0, 1, 2])
@pytest.mark.parametrize("ay", [0, 1, 2])
@pytest.mark.parametrize("bounds", [None, (2, 2, 8, 8), (10, 4, 90, 60)])
def test_align_layer_to_anchor_equals_jax(ax, ay, bounds):
    t, j = _pair(11)
    for doc in (t, j):
        px = np.zeros((H, W, 4), np.uint8)
        px[20:33, 5:40] = (9, 8, 7, 255)
        doc.layers[1].pixels = px
    assert tco.align_layer_to_anchor(t, 1, (ax, ay), bounds) == \
        jco.align_layer_to_anchor(j, 1, (ax, ay), bounds)
    assert _same(t, j)


CLIP_SELECTIONS = {
    "none": lambda: None,
    "rect": lambda: rect_mask(W, H, 10, 12, 41, 50),
    "feathered": lambda: feather(rect_mask(W, H, 30, 8, 80, 40), 4.0),
    "empty": lambda: np.zeros((H, W), np.uint8),
}


@pytest.mark.parametrize("selection", list(CLIP_SELECTIONS))
@pytest.mark.parametrize("at", [None, (-7, 5), (60, 40)])
def test_clipboard_copy_cut_paste_equal_jax(selection, at):
    t, j = _pair(12)
    clips = tclip.Clipboard(), jclip.Clipboard()
    for doc, clip in zip((t, j), clips):
        clip.copy(doc, 0)  # the whole layer: an empty selection keeps it
        doc.selection = CLIP_SELECTIONS[selection]()
        doc.active_layer_index = 2
        clip.copy(doc)
        clip.paste_as_layer(doc, at)
        clip.cut(doc, 1)
        clip.paste_as_layer(doc, at)
    assert np.array_equal(clips[0].image, clips[1].image)
    assert clips[0].origin == clips[1].origin and clips[0].has_content()
    assert _same(t, j)


def test_clipboard_paste_when_empty_equals_jax():
    t, j = _pair(13)
    assert tclip.Clipboard().paste_as_layer(t) is None is jclip.Clipboard().paste_as_layer(j)
    assert _same(t, j)


def _stub_tools(d, monkeypatch):
    store = d / "clip.bin"
    for name, body in (("wl-copy", f"cat > '{store}'"), ("wl-paste", f"cat '{store}'")):
        tool = d / name
        tool.write_text(f"#!/bin/sh\n{body}\n")
        tool.chmod(0o755)
    monkeypatch.setenv("PATH", f"{d}:{os.environ['PATH']}")


def test_os_clipboard_bridge_round_trip_equals_jax(tmp_path, monkeypatch):
    """The OS bridge with stub wl-copy / wl-paste tools backed by a file:
    an image the port puts there, the JAX package reads back, and the
    other way round."""
    _stub_tools(tmp_path, monkeypatch)
    assert tclip.os_clipboard_available() and jclip.os_clipboard_available()
    img = np.random.default_rng(3).integers(0, 256, (9, 13, 4), np.uint8)
    for put, get in ((tclip, jclip), (jclip, tclip)):
        src = put.Clipboard()
        src.image = img.copy()
        assert src.copy_to_os()
        dst = get.Clipboard()
        assert dst.paste_from_os() and np.array_equal(dst.image, img)
        assert dst.origin == (0, 0)
    assert np.array_equal(tclip.os_paste_image(), jclip.os_paste_image())


def test_os_clipboard_bridge_unavailable_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    for m in (tclip, jclip):
        assert not m.os_clipboard_available() and m.os_paste_image() is None
        clip = m.Clipboard()
        assert not clip.copy_to_os()
        clip.image = np.zeros((4, 4, 4), np.uint8)
        assert not clip.copy_to_os() and not clip.paste_from_os()


@pytest.mark.parametrize("idx", [2, 3])
def test_merge_down_rasterizes_text_layers_like_jax(idx):
    """A text layer on either side of a merge is rasterized first and the
    survivor becomes a raster layer."""
    from paintfe_tpu_torch.ops.text_layer import make_text_layer_data

    doc = chip_smoke.editing_document(np.random.default_rng(14), H, W, 4)
    text = doc.layers[2]
    text.content, text.text_data = "text", make_text_layer_data("Merge", 8.0, 12.0)
    text.text_data.blocks[0].runs[0].style.font_size = 24.0
    with tempfile.TemporaryDirectory() as d:
        save_pfe(doc, f"{d}/doc.pfe")
        t, j = load_pfe(f"{d}/doc.pfe"), jpfe.load_pfe(f"{d}/doc.pfe")
    for doc in (t, j):
        doc.layers[3].content, doc.layers[3].adjustment = "raster", None
    tco.merge_down(t, idx, device="cpu")
    jco.merge_down(j, idx)
    assert _same(t, j)
    assert all(l.content == "raster" for l in t.layers[:3])
