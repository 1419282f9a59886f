"""The document-editing path of chip_smoke.py at 128x96 on a four-layer
document, the port on the CPU against the JAX package step by step:
Project.open of a .pfe, the edits of chip_smoke.document_steps
(selections, the magic wand, bucket fill, layer masks, merge down as mask,
the clipboard, colour-to-alpha, flood select, a selected-region flip, the
90-degree and arbitrary rotations, merge down, crop), each pushed to the
project's history; undo to the start and redo to the end, each state held;
then composite_viewport, composite_lod, the soft proof of the composite,
flatten, Project.save to .pfe and .png and a reopen.  Every layer, mask,
selection and output is held at tolerance 0."""

import types

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from paintfe_tpu.core import history as jhistory
from paintfe_tpu.core import mirror as jmirror
from paintfe_tpu.core import project as jproject
from paintfe_tpu.core import selection as jselection
from paintfe_tpu.ops import canvas_ops as jcanvas_ops
from paintfe_tpu.ops import canvas_transform as jcanvas_transform
from paintfe_tpu.ops import clipboard as jclipboard
from paintfe_tpu.ops import color_removal as jcolor_removal
from paintfe_tpu.ops import fill as jfill
from paintfe_tpu_torch.core import mirror as tmirror
from paintfe_tpu_torch.core.canvas import canvas_from_document
from paintfe_tpu_torch.core.project import Project
from paintfe_tpu_torch.io.pfe import save_pfe
from paintfe_tpu_torch.ops import canvas_ops as tcanvas_ops
from paintfe_tpu_torch.ops import canvas_transform as tcanvas_transform
from paintfe_tpu_torch.ops.clipboard import Clipboard

H, W = 96, 128
JAX = types.SimpleNamespace(
    selection=jselection, history=jhistory, mirror=jmirror, project=jproject,
    canvas_ops=jcanvas_ops, canvas_transform=jcanvas_transform, clipboard=jclipboard,
    color_removal=jcolor_removal, fill=jfill)
STEPS = [name for name, _ in chip_smoke.document_steps(chip_smoke.port_modules(), {})]
AFTER = ["undo to the start", "redo to the end", "viewport", "LOD", "soft proof",
         "flatten", "save .pfe", "save .png", "reopen .pfe"]


def _diff(port_canvas, jax_canvas):
    return chip_smoke.document_differences(port_canvas, canvas_from_document(jax_canvas))


@pytest.fixture(scope="module")
def path_run(tmp_path_factory):
    """Runs the path on both packages once; returns what differed, by stage."""
    root = tmp_path_factory.mktemp("document")
    src = root / "doc.pfe"
    save_pfe(chip_smoke.editing_document(np.random.default_rng(9), H, W, n_layers=4), str(src))
    tp, jp = Project.open(src, device="cpu"), jproject.Project.open(src)
    diffs = {"open": _diff(tp.canvas, jp.canvas)}
    tclip, jclip = Clipboard(), jclipboard.Clipboard()
    steps = zip(chip_smoke.document_steps(chip_smoke.port_modules(), {"device": "cpu"}),
                chip_smoke.document_steps(JAX, {}))
    for (name, tstep), (_, jstep) in steps:
        tstep(tp, tclip)
        jstep(jp, jclip)
        diffs[name] = _diff(tp.canvas, jp.canvas)
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

    tc, jc = tp.canvas, jp.canvas
    rect = (W // 5, H // 7, W * 3 // 4, H * 2 // 3)

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return [] if a.shape == b.shape and np.array_equal(a, b) else ["output"]

    diffs["viewport"] = same(tcanvas_transform.composite_viewport(tc, rect, device="cpu"),
                             jcanvas_transform.composite_viewport(jc, rect))
    diffs["LOD"] = same(tcanvas_transform.composite_lod(tc, device="cpu"),
                        jcanvas_transform.composite_lod(jc))
    diffs["soft proof"] = same(tmirror.soft_proof_cmyk(tc.composite(device="cpu")),
                               jmirror.soft_proof_cmyk(jc.composite()))
    tcanvas_ops.flatten(tc, device="cpu")
    jcanvas_ops.flatten(jc)
    diffs["flatten"] = _diff(tc, jc)
    for ext in ("pfe", "png"):
        tp.save(root / f"port.{ext}")
        jp.save(root / f"jax.{ext}")
        a, b = (root / f"port.{ext}").read_bytes(), (root / f"jax.{ext}").read_bytes()
        diffs[f"save .{ext}"] = [] if a == b else [f"{ext} bytes"]
    diffs["save .png"] += same(Image.open(root / "port.png"), Image.open(root / "jax.png"))
    diffs["reopen .pfe"] = _diff(Project.open(root / "port.pfe", device="cpu").canvas,
                                 jproject.Project.open(root / "jax.pfe").canvas)
    return diffs


@pytest.mark.parametrize("stage", ["open"] + STEPS + AFTER)
def test_document_path_step_equals_jax(path_run, stage):
    assert path_run[stage] == []


def test_document_path_edits_change_the_document(tmp_path):
    """The steps do real work at this size: the wand and flood select pick
    part of the canvas, the rotations move pixels, the crop shrinks it."""
    src = tmp_path / "doc.pfe"
    save_pfe(chip_smoke.editing_document(np.random.default_rng(9), H, W, n_layers=4), str(src))
    p = Project.open(src, device="cpu")
    clip = Clipboard()
    seen = {}
    for name, step in chip_smoke.document_steps(chip_smoke.port_modules(), {"device": "cpu"}):
        before = [l.pixels for l in p.canvas.layers]
        step(p, clip)
        sel = p.canvas.selection
        seen[name] = (None if sel is None else float((sel > 0).mean()),
                      [l.pixels is b for l, b in zip(p.canvas.layers, before)])
    for name in ("magic wand", "flood select"):
        share = seen[name][0]
        assert share is not None and 0.02 < share < 0.9, (name, share)
    assert not any(seen["rotate 17.5 bilinear"][1]) and not any(seen["rotate 90 cw"][1])
    assert (p.canvas.width, p.canvas.height) != (H, W) and len(p.canvas.layers) == 4
