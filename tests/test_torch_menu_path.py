"""The menu-edit path of chip_smoke.py at 128x96 on a four-layer document,
the port on the CPU against the JAX package step by step: Project.open of
a .pfe, an elliptic selection, then the steps of chip_smoke.menu_steps
(the 27 adjustment functions with a histogram read, the bokeh and zoom
blurs, dents, grid, canvas border, drop shadow, both glitches, contours,
the colour filter, four Liquify strokes and the field's warp, a mesh warp,
a linear and a radial eraser gradient on a new layer), each pushed to the
project's history; undo to the start and redo to the end, each state
held; then flatten and Project.save to .pfe and .png.  Every layer, the
histogram, the Liquify field and every output is held at tolerance 0."""

import types

import numpy as np
import pytest

import chip_smoke
from paintfe_tpu.core import history as jhistory
from paintfe_tpu.core import project as jproject
from paintfe_tpu.core import selection as jselection
from paintfe_tpu.ops import adjustments as jadjustments
from paintfe_tpu.ops import canvas_ops as jcanvas_ops
from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.ops import gradient as jgradient
from paintfe_tpu.ops import luts as jluts
from paintfe_tpu.ops import transform as jtransform
from paintfe_tpu.ops.effects import artistic as jartistic
from paintfe_tpu.ops.effects import contours as jcontours
from paintfe_tpu.ops.effects import distort as jdistort
from paintfe_tpu.ops.effects import glitch as jglitch
from paintfe_tpu.ops.effects import render as jrender
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.core.history import HistoryManager
from paintfe_tpu_torch.core.project import Project
from paintfe_tpu_torch.io.pfe import save_pfe
from paintfe_tpu_torch.ops import canvas_ops as tcanvas_ops

H, W = 96, 128
JAX = types.SimpleNamespace(
    selection=jselection, history=jhistory, adjustments=jadjustments, luts=jluts,
    canvas_ops=jcanvas_ops, filters=jfilters, gradient=jgradient, transform=jtransform,
    artistic=jartistic, contours=jcontours, distort=jdistort, glitch=jglitch,
    render=jrender)
STEPS = [name for name, _ in chip_smoke.menu_steps(chip_smoke.menu_modules(), {})]
AFTER = ["undo to the start", "redo to the end", "flatten", "save .pfe", "save .png"]


def _diff(port_canvas, jax_canvas):
    return chip_smoke.document_differences(port_canvas, canvas_from_document(jax_canvas))


def _open(src):
    tp, jp = Project.open(src, device="cpu"), jproject.Project.open(src)
    tp.history = HistoryManager(max_entries=100, memory_limit_bytes=1 << 30)
    jp.history = jhistory.HistoryManager(max_entries=100, memory_limit_bytes=1 << 30)
    return tp, jp


@pytest.fixture(scope="module")
def path_run(tmp_path_factory):
    """Runs the path on both packages once; returns what differed, by stage."""
    root = tmp_path_factory.mktemp("menu")
    src = root / "doc.pfe"
    save_pfe(chip_smoke.editing_document(np.random.default_rng(11), H, W, n_layers=4),
             str(src))
    tp, jp = _open(src)
    diffs = {"open": _diff(tp.canvas, jp.canvas)}
    tstate, jstate = {}, {}
    steps = zip(chip_smoke.menu_steps(chip_smoke.menu_modules(), {"device": "cpu"}),
                chip_smoke.menu_steps(JAX, {}))
    for (name, tstep), (_, jstep) in steps:
        tstep(tp, tstate)
        jstep(jp, jstate)
        diffs[name] = _diff(tp.canvas, jp.canvas)
        if name == "histogram" and not np.array_equal(tstate[name], jstate[name]):
            diffs[name].append("histogram")
        if name.startswith("liquify") and not np.array_equal(
                tstate["field"].data.view(np.uint32), jstate["field"].data.view(np.uint32)):
            diffs[name].append("field")
    diffs["undo to the start"] = []
    while jp.history.can_undo():
        assert tp.history.undo(tp.canvas) and jp.history.undo(jp.canvas)
        diffs["undo to the start"] += _diff(tp.canvas, jp.canvas)
    assert not tp.history.can_undo()
    diffs["undo to the start"] += _diff(tp.canvas, canvas_from_document(
        jproject.Project.open(src).canvas))
    diffs["redo to the end"] = []
    while jp.history.can_redo():
        assert tp.history.redo(tp.canvas) and jp.history.redo(jp.canvas)
        diffs["redo to the end"] += _diff(tp.canvas, jp.canvas)
    assert not tp.history.can_redo()
    tcanvas_ops.flatten(tp.canvas, device="cpu")
    jcanvas_ops.flatten(jp.canvas)
    diffs["flatten"] = _diff(tp.canvas, jp.canvas)
    for ext in ("pfe", "png"):
        tp.save(root / f"port.{ext}")
        jp.save(root / f"jax.{ext}")
        a, b = (root / f"port.{ext}").read_bytes(), (root / f"jax.{ext}").read_bytes()
        diffs[f"save .{ext}"] = [] if a == b else [f"{ext} bytes"]
    return diffs


@pytest.mark.parametrize("stage", ["open"] + STEPS + AFTER)
def test_menu_path_step_equals_jax(path_run, stage):
    assert path_run[stage] == []


def test_menu_path_covers_every_menu_op():
    """The path runs each adjustment function of the JAX package once, and
    pushes one command a step but for the reads."""
    ops = {op for _, module, op, _ in chip_smoke.MENU_OPS if module == "adjustments"}
    public = {n for n, v in vars(jadjustments).items()
              if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", None) == "paintfe_tpu.ops.adjustments"}
    assert public <= ops and len(ops) == 27
    assert set(chip_smoke.MENU_READS) <= set(STEPS)


def test_menu_path_edits_change_the_layer(tmp_path):
    """Every step that pushes a command changes the layer it edits at this
    size, and the history holds one command a step but the reads."""
    src = tmp_path / "doc.pfe"
    save_pfe(chip_smoke.editing_document(np.random.default_rng(11), H, W, n_layers=4),
             str(src))
    p, _ = _open(src)
    state = {}
    unchanged = []
    for name, step in chip_smoke.menu_steps(chip_smoke.menu_modules(), {"device": "cpu"}):
        n = len(p.history.undo_stack)
        before = [l.pixels for l in p.canvas.layers]
        step(p, state)
        if len(p.history.undo_stack) == n:
            assert name in chip_smoke.MENU_READS
            continue
        if name not in ("ellipse", "new layer"):
            idx = p.canvas.active_layer_index
            if np.array_equal(before[idx], p.canvas.layers[idx].pixels):
                unchanged.append(name)
    assert unchanged == []
    assert len(p.history.undo_stack) == len(STEPS) - len(chip_smoke.MENU_READS)
    sel = p.canvas.selection
    assert sel is not None and 0.1 < float((sel > 0).mean()) < 0.7
