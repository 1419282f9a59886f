"""The tools path of chip_smoke.py at 128x96 on a six-layer document with a
u16 deep layer, the port on the CPU against the JAX package step by step:
Project.open of a .pfe, then the steps of chip_smoke.tool_steps (three
lassos; soft, pencil, eraser, Dodge, Burn, Sponge and scatter-with-jitter
brush lines; a rotated stock-tip stroke; two Bézier strokes; five shapes;
a shape on a new layer merged down; clone and heal strokes; PatchMatch and
instant-brush dabs in a hole; the perspective crop), each pushed to the
project's history; undo to the start and redo to the end, each state
held; then flatten and Project.save to .pfe and .png.  Every layer, mask,
deep buffer, selection, history entry and output is held at tolerance 0.
Also DeepRgbaBuffer.sync_region_from_u8 in every format, from a host
array and from a tensor, against the JAX method."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from paintfe_tpu.core import deep as jdeep
from paintfe_tpu.core import history as jhistory
from paintfe_tpu.core import project as jproject
from paintfe_tpu.core import selection as jselection
from paintfe_tpu.ops import canvas_ops as jcanvas_ops
from paintfe_tpu.ops import inpaint as jinpaint
from paintfe_tpu.ops import shapes as jshapes
from paintfe_tpu.tools import brush as jbrush
from paintfe_tpu.tools import brush_tips as jbrush_tips
from paintfe_tpu.tools import clone_heal as jclone_heal
from paintfe_tpu.tools import vector_tools as jvector_tools
from paintfe_tpu_torch.core import deep as tdeep
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.core.history import HistoryManager
from paintfe_tpu_torch.core.project import Project
from paintfe_tpu_torch.io.pfe import save_pfe
from paintfe_tpu_torch.ops import canvas_ops as tcanvas_ops

H, W = 96, 128
JAX = types.SimpleNamespace(
    brush=jbrush, brush_tips=jbrush_tips, clone_heal=jclone_heal,
    vector_tools=jvector_tools, shapes=jshapes, inpaint=jinpaint, selection=jselection,
    history=jhistory, canvas_ops=jcanvas_ops, target=np.array,
    zeros=lambda h, w: np.zeros((h, w, 4), np.uint8), host=np.asarray,
    show=lambda c, rect, state: None)
STEPS = [name for name, _ in chip_smoke.tool_steps(chip_smoke.tool_modules("cpu"), {})]
AFTER = ["undo to the start", "redo to the end", "flatten", "save .pfe", "save .png"]


def _diff(tp, jp):
    """The parts (chip_smoke._tools_parts) of the two projects that differ:
    the canvas, each layer with its pixels, mask and deep buffer, the
    selection and the history."""
    a = chip_smoke._tools_parts(tp, {}, None, {})
    b = chip_smoke._tools_parts(jp, {}, None, {})
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def _open(src):
    tp, jp = Project.open(src, device="cpu"), jproject.Project.open(src)
    tp.history = HistoryManager(max_entries=100, memory_limit_bytes=1 << 30)
    jp.history = jhistory.HistoryManager(max_entries=100, memory_limit_bytes=1 << 30)
    return tp, jp


@pytest.fixture(scope="module")
def path_run(tmp_path_factory):
    """Runs the path on both packages once; returns what differed, by stage,
    and each step's stamps on the port."""
    root = tmp_path_factory.mktemp("tools")
    src = root / "doc.pfe"
    save_pfe(chip_smoke.tools_document(np.random.default_rng(13), H, W), str(src))
    tp, jp = _open(src)
    diffs = {"open": _diff(tp, jp)}
    stamps = {}
    tstate, jstate = {}, {}
    steps = zip(chip_smoke.tool_steps(chip_smoke.tool_modules("cpu"), {"device": "cpu"}),
                chip_smoke.tool_steps(JAX, {}))
    for (name, tstep), (_, jstep) in steps:
        stamps[name] = (tstep(tp, tstate), jstep(jp, jstate))
        diffs[name] = _diff(tp, jp)
    diffs["undo to the start"] = []
    while jp.history.can_undo():
        assert tp.history.undo(tp.canvas) and jp.history.undo(jp.canvas)
        diffs["undo to the start"] += _diff(tp, jp)
    assert not tp.history.can_undo()
    diffs["undo to the start"] += chip_smoke.document_differences(
        tp.canvas, canvas_from_document(jproject.Project.open(src).canvas))
    diffs["redo to the end"] = []
    while jp.history.can_redo():
        assert tp.history.redo(tp.canvas) and jp.history.redo(jp.canvas)
        diffs["redo to the end"] += _diff(tp, jp)
    assert not tp.history.can_redo()
    tcanvas_ops.flatten(tp.canvas, device="cpu")
    jcanvas_ops.flatten(jp.canvas)
    diffs["flatten"] = _diff(tp, jp)
    for ext in ("pfe", "png"):
        tp.save(root / f"port.{ext}")
        jp.save(root / f"jax.{ext}")
        a, b = (root / f"port.{ext}").read_bytes(), (root / f"jax.{ext}").read_bytes()
        diffs[f"save .{ext}"] = [] if a == b else [f"{ext} bytes"]
    return diffs, stamps, tstate


@pytest.mark.parametrize("stage", ["open"] + STEPS + AFTER)
def test_tools_path_step_equals_jax(path_run, stage):
    assert path_run[0][stage] == []


def test_tools_path_steps_stamp_and_show(path_run):
    """Each step reports the same stamps on both packages; the strokes stamp
    more than once; the display was composited at every stroke and fill."""
    _, stamps, tstate = path_run
    assert all(t == j for t, j in stamps.values())
    strokes = [name for name, *_ in chip_smoke.TOOL_BRUSHES] + [
        "image tip", "clone", "heal"] + [name for name, *_ in chip_smoke.TOOL_BEZIERS]
    assert all(stamps[name][0] > 1 for name in strokes)
    assert tstate["shown"].shape == (tstate["shown"].shape[0], tstate["shown"].shape[1], 4)
    assert tstate["composites"] > len(strokes)


def test_tools_path_edits_change_the_document(tmp_path):
    """Every step changes the document at this size: each stroke, shape and
    fill the active layer, each selection the selection; the crop the
    size.  The history holds one command a step."""
    src = tmp_path / "doc.pfe"
    save_pfe(chip_smoke.tools_document(np.random.default_rng(13), H, W), str(src))
    p, _ = _open(src)
    state = {}
    unchanged = []
    for name, step in chip_smoke.tool_steps(chip_smoke.tool_modules("cpu"), {"device": "cpu"}):
        c = p.canvas
        before = ([l.pixels for l in c.layers], c.selection, c.width)
        step(p, state)
        if name in chip_smoke.TOOL_SELECTS:
            same = np.array_equal(before[1] if before[1] is not None else 0,
                                  c.selection if c.selection is not None else 0)
        elif name == "perspective crop":
            same = c.width == before[2]
        elif name == "new layer":
            same = len(c.layers) == len(before[0])
        elif name == "merge down":
            same = len(c.layers) == len(before[0])
        else:
            idx = c.active_layer_index
            same = np.array_equal(before[0][idx], c.layers[idx].pixels)
        if same:
            unchanged.append(name)
    assert unchanged == []
    assert len(p.history.undo_stack) == len(STEPS)


@pytest.mark.parametrize("fmt", list(jdeep.PixelFormat), ids=lambda f: f.value)
@pytest.mark.parametrize("rect", [(3, 5, 40, 30), (-4, -6, 12, 9), (30, 20, 60, 70),
                                  (10, 10, 10, 20)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["array", "tensor"])
def test_sync_region_from_u8_equals_jax(fmt, rect, as_tensor):
    """The dirty region in every format (u8, u16 as v * 257, f16 through the
    truncating converter, f32 as v / 255), the origin clamped, an empty
    region a no-op; from a host array and from a tensor."""
    rng = np.random.default_rng(5)
    h, w = 37, 53
    base = rng.integers(0, 256, (h, w, 4), np.uint8)
    preview = rng.integers(0, 256, (h, w, 4), np.uint8)
    jbuf = jdeep.DeepRgbaBuffer.from_rgba8(base, fmt)
    tbuf = tdeep.DeepRgbaBuffer.from_rgba8(base, tdeep.PixelFormat(fmt.value))
    jbuf.sync_region_from_u8(preview, *rect)
    tbuf.sync_region_from_u8(torch.from_numpy(preview) if as_tensor else preview, *rect)
    assert tbuf.data.dtype == jbuf.data.dtype
    np.testing.assert_array_equal(tbuf.data.view(np.uint8), jbuf.data.view(np.uint8))
