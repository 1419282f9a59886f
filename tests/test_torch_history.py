"""The port's history and projects (paintfe_tpu_torch.core.{history,project},
Layer.clone) against the JAX package's: every command's undo and redo, the
history's entry and memory trims, Layer.clone's value semantics, Project
new / open (.pfe, .pdn, animated GIF and APNG, 16-bit PNG with its deep
payload, a plain PNG) / save (.pfe, .png, 16-bit .png), and the identity
cache after an undo (ROADMAP C10): the JAX package's composite_device is
stale after a PixelPatch undo, the port's is not.  The same seeded
inputs, device "cpu", tolerance 0."""

import tempfile

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from paintfe_tpu.core import canvas as jcanvas
from paintfe_tpu.core import device as jdevice
from paintfe_tpu.core import history as jhist
from paintfe_tpu.core import project as jproject
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu_torch.core import canvas as tcanvas
from paintfe_tpu_torch.core import device as tdevice
from paintfe_tpu_torch.core import history as thist
from paintfe_tpu_torch.core import project as tproject
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.io.pfe import load_pfe, save_pfe

H, W = 96, 128


def _same(port_canvas, jax_canvas):
    return chip_smoke.document_differences(port_canvas, canvas_from_document(jax_canvas)) == []


def _pair(seed=1, n_layers=4):
    """The same document in both packages: chip_smoke's editing document,
    the JAX package's through its own .pfe loader."""
    doc = chip_smoke.editing_document(np.random.default_rng(seed), H, W, n_layers)
    with tempfile.TemporaryDirectory() as d:
        save_pfe(doc, f"{d}/doc.pfe")
        return load_pfe(f"{d}/doc.pfe"), jpfe.load_pfe(f"{d}/doc.pfe")


def _edit(px, seed, box):
    y0, y1, x0, x1 = box
    out = px.copy()
    out[y0:y1, x0:x1] = np.random.default_rng(seed).integers(0, 256, (y1 - y0, x1 - x0, 4),
                                                             np.uint8)
    return out


@pytest.mark.parametrize("box", [(10, 20, 10, 20), (0, 96, 60, 70), (63, 65, 63, 65),
                                 (0, 0, 0, 0)])
def test_pixel_patch_equals_jax(box):
    t, j = _pair()
    before = t.layers[1].pixels
    after = _edit(before, 3, box)
    tp, jp = thist.PixelPatch("p", 1, before, after), jhist.PixelPatch("p", 1, before, after)
    assert [(x, y) for x, y, *_ in tp.tiles] == [(x, y) for x, y, *_ in jp.tiles]
    assert tp.memory_bytes() == jp.memory_bytes() and tp.is_empty() == jp.is_empty()
    th, jh = thist.HistoryManager(), jhist.HistoryManager()
    t.layers[1].pixels, j.layers[1].pixels = after.copy(), after.copy()
    th.push(tp)
    jh.push(jp)
    assert th.can_undo() == jh.can_undo() == (not tp.is_empty())
    for op in ("undo", "redo", "undo"):
        assert getattr(th, op)(t) == getattr(jh, op)(j)
        assert _same(t, j)


def test_pixel_patch_undo_and_redo_assign_a_new_array():
    t, _ = _pair()
    before = t.layers[1].pixels
    after = _edit(before, 4, (5, 70, 5, 70))
    t.layers[1].pixels = after
    h = thist.HistoryManager()
    h.push(thist.PixelPatch("p", 1, before, after))
    h.undo(t)
    undone = t.layers[1].pixels
    assert undone is not after and np.array_equal(undone, before)
    assert np.array_equal(after, _edit(before, 4, (5, 70, 5, 70)))  # not written into
    h.redo(t)
    assert t.layers[1].pixels is not undone and np.array_equal(t.layers[1].pixels, after)
    assert np.array_equal(undone, before)


@pytest.mark.parametrize("op", ["add", "delete"])
def test_layer_op_command_equals_jax(op):
    t, j = _pair()
    for doc, hist in ((t, thist), (j, jhist)):
        prev = doc.active_layer_index
        if op == "add":
            layer = (tcanvas if doc is t else jcanvas).Layer.new("new", W, H, (1, 2, 3, 4))
            doc.layers.insert(3, layer)
            idx = 3
        else:
            idx, layer = 1, doc.layers.pop(1)
        doc.active_layer_index = idx if op == "add" else 0
        doc.cmd = hist.LayerOpCommand(op, op, idx, layer, prev, doc.active_layer_index)
    th, jh = thist.HistoryManager(), jhist.HistoryManager()
    th.push(t.cmd)
    jh.push(j.cmd)
    assert t.cmd.memory_bytes() == j.cmd.memory_bytes()
    for step in ("undo", "redo", "undo", "redo"):
        getattr(th, step)(t)
        getattr(jh, step)(j)
        assert _same(t, j)


def test_single_layer_snapshot_equals_jax():
    t, j = _pair()
    before = t.layers[0].pixels
    after = _edit(before, 5, (0, 50, 0, 128))
    cmds = (thist.SingleLayerSnapshotCommand("s", 0, before, after),
            jhist.SingleLayerSnapshotCommand("s", 0, before, after))
    t.layers[0].pixels, j.layers[0].pixels = after.copy(), after.copy()
    assert cmds[0].memory_bytes() == cmds[1].memory_bytes()
    for step in ("undo", "redo", "undo"):
        getattr(cmds[0], step)(t)
        getattr(cmds[1], step)(j)
        assert _same(t, j)


def test_snapshot_command_restores_everything_like_jax():
    t, j = _pair()
    cmds = (thist.SnapshotCommand("s", t), jhist.SnapshotCommand("s", j))
    for doc, mod in ((t, tcanvas), (j, jcanvas)):
        doc.folders.append(mod.LayerFolder(id=4, name="f", visible=False))
        doc.layers[2].folder_id = 4
        doc.layers[1].mask = None
        doc.layers.pop(0)
        doc.selection = np.full((H, W), 255, np.uint8)
        doc.width, doc.height, doc.active_layer_index = 50, 40, 1
    for cmd, doc in zip(cmds, (t, j)):
        cmd.finalize(doc)
    assert cmds[0].memory_bytes() == cmds[1].memory_bytes()
    for step in ("undo", "redo", "undo", "redo"):
        getattr(cmds[0], step)(t)
        getattr(cmds[1], step)(j)
        assert _same(t, j)


@pytest.mark.parametrize("limit", [100_000, 400_000, 3_000_000, 1 << 30])
@pytest.mark.parametrize("max_entries", [3, 50])
def test_history_trim_equals_jax(limit, max_entries):
    """The memory budget drops the oldest commands but always keeps one;
    the entry count is pruned first."""
    docs = _pair()
    managers = (thist.HistoryManager(max_entries, limit), jhist.HistoryManager(max_entries, limit))
    for i in range(8):
        for doc, h, hist in zip(docs, managers, (thist, jhist)):
            before = doc.layers[0].pixels
            after = _edit(before, i, (0, 8 * (i + 1), 0, 16 * (i + 1)))
            doc.layers[0].pixels = after
            h.push(hist.SingleLayerSnapshotCommand(f"fill {i}", 0, before, after)
                   if i % 2 else hist.PixelPatch(f"fill {i}", 0, before, after))
        assert [c.name for c in managers[0].undo_stack] == \
            [c.name for c in managers[1].undo_stack]
        assert managers[0].memory_bytes() == managers[1].memory_bytes()
        assert len(managers[0].undo_stack) >= 1
    while managers[1].undo(docs[1]):
        assert managers[0].undo(docs[0])
        assert _same(*docs)
    assert not managers[0].can_undo()
    managers[0].clear()
    assert not managers[0].can_redo()


def test_push_ignores_empty_patches_and_clears_redo():
    t, _ = _pair()
    h = thist.HistoryManager()
    h.push(thist.PixelPatch("empty", 0, t.layers[0].pixels, t.layers[0].pixels))
    assert not h.can_undo()
    after = _edit(t.layers[0].pixels, 6, (0, 9, 0, 9))
    h.push(thist.PixelPatch("a", 0, t.layers[0].pixels, after))
    h.undo(t)
    assert h.can_redo()
    h.push(thist.PixelPatch("b", 0, t.layers[0].pixels, after))
    assert not h.can_redo()


def test_layer_clone_has_value_semantics_like_jax():
    from paintfe_tpu_torch.core.deep import DeepRgbaBuffer, PixelFormat
    from paintfe_tpu_torch.ops.text_layer import make_text_layer_data

    t, j = _pair()
    layer = t.layers[1]
    layer.deep_pixels = DeepRgbaBuffer(PixelFormat.RGBA_U16,
                                       np.arange(H * W * 4, dtype=np.uint16))
    layer.text_data = make_text_layer_data("hi", 3.0, 4.0)
    layer.mask = np.arange(H * W, dtype=np.uint8).reshape(H, W)
    kept = layer.pixels.copy(), layer.mask.copy()
    c = layer.clone()
    assert chip_smoke.document_differences(
        tcanvas.Canvas(W, H, [c]), tcanvas.Canvas(W, H, [layer])) == []
    for name in ("pixels", "mask", "deep_pixels", "text_data"):
        assert getattr(c, name) is not getattr(layer, name)
    c.pixels[...] = 7
    c.mask[...] = 9
    c.deep_pixels.data[0] = 5
    c.text_data.blocks[0].runs[0].text = "changed"
    assert np.array_equal(layer.pixels, kept[0]) and np.array_equal(layer.mask, kept[1])
    assert layer.deep_pixels.data[0] == 0 and layer.text_data.blocks[0].plain_text() == "hi"
    adj = t.layers[3]
    ca = adj.clone()
    ca.adjustment.brightness = -50.0
    assert adj.adjustment.brightness == 10.0
    # the JAX package's clone of the same layer: the same state, copied
    jc = j.layers[0].clone()
    assert jc.pixels is not j.layers[0].pixels
    assert chip_smoke.document_differences(
        tcanvas.Canvas(W, H, [t.layers[0].clone()]),
        canvas_from_document(jcanvas.Canvas(W, H, [jc]))) == []


def _unaligned(a):
    """A copy of `a` whose data starts 16 bytes past a 64-byte boundary."""
    buf = np.empty(a.nbytes + 128, np.uint8)
    start = (-buf.ctypes.data) % 64 + 16
    out = buf[start:start + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def test_composite_device_after_an_undo_c10():
    """ROADMAP C10: the JAX package's PixelPatch.undo writes the tiles into
    layer.pixels in place, so its DeviceLayerCache (which revalidates by
    array identity) serves the upload from before the undo; the port's
    undo assigns a new array, and its composite_device equals its host
    composite and the JAX host composite of the pre-edit document.  JAX's
    CPU backend takes a 64-byte-aligned host array without a copy (then
    the in-place write reaches its "device" array too), so the edited
    array lies off that alignment: its upload is a copy, as it always is
    on an accelerator."""
    n = 128
    base = np.random.default_rng(7).integers(0, 256, (n, n, 4), np.uint8)
    top = np.random.default_rng(8).integers(0, 256, (n, n, 4), np.uint8)
    j = jcanvas.Canvas(width=n, height=n)
    j.layers = [jcanvas.Layer(name="a", pixels=base.copy()),
                jcanvas.Layer(name="b", pixels=top.copy(), blend_mode=2)]
    t = canvas_from_document(j)
    pre_edit = np.asarray(j.composite())
    results = {}
    for doc, hist, dev in ((j, jhist, jdevice), (t, thist, tdevice)):
        before = doc.layers[1].pixels
        after = _unaligned(_edit(before, 9, (20, 90, 30, 100)))
        doc.layers[1].pixels = after
        h = hist.HistoryManager()
        h.push(hist.PixelPatch("stroke", 1, before, after))
        cache = dev.DeviceLayerCache() if dev is jdevice else dev.DeviceLayerCache("cpu")
        edited = np.asarray(dev.composite_device(doc, cache))
        h.undo(doc)
        results[dev] = (edited, np.asarray(dev.composite_device(doc, cache)))
    jax_edited, jax_after_undo = results[jdevice]
    port_edited, port_after_undo = results[tdevice]
    assert not np.array_equal(jax_edited, pre_edit)
    # the JAX package: stale, still the edited document
    assert np.array_equal(jax_after_undo, jax_edited)
    assert not np.array_equal(jax_after_undo, np.asarray(j.composite()))
    assert np.array_equal(np.asarray(j.composite()), pre_edit)
    # the port: the pre-edit document, on the device path and the host path
    assert np.array_equal(port_edited, jax_edited)
    assert np.array_equal(port_after_undo, t.composite(device="cpu"))
    assert np.array_equal(port_after_undo, pre_edit)


def _project_pair(path, **kw):
    return tproject.Project.open(path, device="cpu", **kw), jproject.Project.open(path)


def _same_project(tp, jp):
    return (_same(tp.canvas, jp.canvas) and tp.name == jp.name and tp.path == jp.path
            and tp.was_animated == jp.was_animated and tp.animation_fps == jp.animation_fps
            and tp.title == jp.title)


def test_project_new_untitled_equals_jax():
    tp = tproject.Project.new_untitled(3, 40, 30, history_limit=7, device="cpu")
    jp = jproject.Project.new_untitled(3, 40, 30, history_limit=7)
    assert _same(tp.canvas, jp.canvas) and tp.name == jp.name == "Untitled-3"
    assert tp.history.max_entries == jp.history.max_entries == 7
    assert tp.device == "cpu" and tp.title == jp.title
    tp.mark_dirty()
    jp.mark_dirty()
    assert tp.title == jp.title == "Untitled-3*"
    with pytest.raises(ValueError, match="no path"):
        tp.save()


def test_project_open_pfe_and_pdn_equal_jax(tmp_path):
    doc, _ = _pair(11, 4)
    save_pfe(doc, str(tmp_path / "d.pfe"))
    assert _same_project(*_project_pair(tmp_path / "d.pfe"))
    rng = np.random.default_rng(12)
    layers = [dict(name=f"l{k}", pixels=rng.integers(0, 256, (H, W, 4), np.uint8),
                   visible=True, opacity=200 + k, blend=b)
              for k, b in enumerate(("Normal", "Multiply", "Screen"))]
    (tmp_path / "d.pdn").write_bytes(chip_smoke.pdn_bytes(layers, W, H))
    assert _same_project(*_project_pair(tmp_path / "d.pdn"))


@pytest.mark.parametrize("fmt,duration", [("gif", 40), ("png", 125), ("gif", 0)])
def test_project_open_animated_equals_jax(tmp_path, fmt, duration):
    rng = np.random.default_rng(13)
    frames = [rng.integers(0, 256, (24, 32, 4), np.uint8) for _ in range(3)]
    for f in frames:
        f[..., 3] = 255
    path = tmp_path / f"anim.{fmt}"
    ims = [Image.fromarray(f, "RGBA") for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=duration, loop=0)
    tp, jp = _project_pair(path)
    assert tp.was_animated and _same_project(tp, jp)


def test_project_open_deep_and_plain_png_equal_jax(tmp_path):
    rng = np.random.default_rng(14)
    deep = rng.integers(0, 65536, (20, 30, 4)).astype(np.uint16)
    (tmp_path / "deep.png").write_bytes(chip_smoke.png16_bytes(deep))
    tp, jp = _project_pair(tmp_path / "deep.png")
    assert _same_project(tp, jp)
    tl, jl = tp.canvas.layers[0], jp.canvas.layers[0]
    assert tl.pixel_format.value == jl.pixel_format.value
    assert np.array_equal(tl.deep_pixels.data, jl.deep_pixels.data)
    Image.fromarray(rng.integers(0, 256, (20, 30, 4), np.uint8), "RGBA").save(
        tmp_path / "plain.png")
    assert _same_project(*_project_pair(tmp_path / "plain.png"))


@pytest.mark.parametrize("src,ext", [("d.pfe", "pfe"), ("d.pfe", "png"), ("deep.png", "png"),
                                     ("deep.png", "tiff")])
def test_project_save_equals_jax(tmp_path, src, ext):
    doc, _ = _pair(15, 4)
    save_pfe(doc, str(tmp_path / "d.pfe"))
    deep = np.random.default_rng(16).integers(0, 65536, (20, 30, 4)).astype(np.uint16)
    (tmp_path / "deep.png").write_bytes(chip_smoke.png16_bytes(deep))
    tp, jp = _project_pair(tmp_path / src)
    tp.mark_dirty()
    jp.mark_dirty()
    tp.save(tmp_path / f"port.{ext}")
    jp.save(tmp_path / f"jax.{ext}")
    assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    assert not tp.is_dirty and tp.name == "port" and tp.path == tmp_path / f"port.{ext}"


def test_project_device_defaults_to_the_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproject.Project.new_untitled(1, 8, 8)


def test_package_exports_load_lazily():
    """paintfe_tpu_torch exports BlendMode, Canvas, Layer and Project as the
    JAX package does; importing the package imports neither torch nor JAX
    until an export is read."""
    import subprocess
    import sys

    code = ("import sys, paintfe_tpu_torch as p\n"
            "assert not any(m in sys.modules for m in ('torch', 'jax', 'paintfe_tpu'))\n"
            "from paintfe_tpu_torch import BlendMode, Canvas, Layer, Project\n"
            "from paintfe_tpu_torch.core.project import Project as P\n"
            "assert Project is P and 'jax' not in sys.modules\n"
            "assert {'BlendMode', 'Canvas', 'Layer', 'Project'} <= set(dir(p))\n"
            "print(sorted(p._EXPORTS))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(chip_smoke.pathlib.Path(chip_smoke.__file__).parent))
    assert out.returncode == 0, out.stderr
    import paintfe_tpu

    assert out.stdout.strip() == str(sorted(paintfe_tpu._EXPORTS))
    with pytest.raises(AttributeError, match="no attribute"):
        import paintfe_tpu_torch

        paintfe_tpu_torch.Nope
