"""The flatten after each opacity change of a layered document: request i
sets a new opacity, drawn from the seed, on one layer (cycling through
them), then calls `parallel.spatial.composite_spatial(layers, modes,
opacities, rows_mesh)`.  The document lies on the first card; the mesh
has the traffic's `mesh_entries` cards.

SMALL and FAULTS serve the benchmark's tests, as in spatial_chain.py."""

from __future__ import annotations

import dataclasses

import torch

from portbench import compare, faults, inputs
from portbench.reference import composite, strips

# the tests' sizes
SMALL = {"width": 64, "height": 48}


@dataclasses.dataclass
class State:
    cell: object
    layers: torch.Tensor
    covered: list
    modes: list
    opacities: list
    mesh: object
    start: int


def setup(cell) -> State:
    from paintfe_tpu_torch.parallel import spatial

    layers, covered = inputs.layered_document(cell.config, cell.devices[0], cell.seed)
    draw = inputs.rng(cell.seed)
    lo, hi = cell.traffic["opacity"]
    opacities = [float(x) for x in draw.uniform(lo, hi, layers.shape[0])]
    start = int(draw.integers(0, layers.shape[0]))
    mesh = spatial.rows_mesh(cell.devices[:cell.traffic["mesh_entries"]])
    return State(cell, layers, covered, list(cell.config["blend_modes"]), opacities, mesh, start)


def _reference(state: State, opacities, ft, join=False):
    """The fold's plain reference in row strips: (a, b, rows a..b) each, or
    joined into the whole image."""
    fn = strips.by_strips if join else strips.strips
    return fn(lambda *rows: composite.apply(rows, state.modes, opacities, ft),
              list(state.layers.unbind(0)), state.cell.traffic["strip_rows"], 0)


def runs_px(state: State, opacities) -> list:
    """Pixels of each layer whose blend runs: not clear, and not
    NORMAL-opaque at full opacity (the layers are opaque where not clear)."""
    return [0 if (m == 0 and o >= 1.0) else c
            for m, o, c in zip(state.modes, opacities, state.covered)]


def call(state: State, i: int):
    draw = inputs.rng(state.cell.seed, i)
    layer = (state.start + i) % len(state.opacities)
    state.opacities[layer] = float(draw.uniform(*state.cell.traffic["opacity"]))
    opacities = list(state.opacities)
    if state.cell.control:
        out = _reference(state, opacities, torch.bfloat16, join=True)
    else:
        from paintfe_tpu_torch.parallel import spatial

        out = spatial.composite_spatial(state.layers, state.modes, opacities, state.mesh)
    h, w = state.layers.shape[1:3]
    work = {"kcomposite": {"px": h * w, "modes": state.modes,
                           "runs_px": runs_px(state, opacities)}}
    return out, {"pixels": h * w, "work": work, "opacities": opacities}


def check(state: State, kept) -> dict:
    worst = 0 if kept else compare.NOTHING
    for _, out, info in kept:
        for lo, hi, want in _reference(state, info["opacities"], torch.float32):
            worst = max(worst, compare.max_abs_diff(out[lo:hi], want))
    return {"max_abs_diff": (worst, compare.LIMIT)}


def _state_unchanged(monkeypatch):
    from paintfe_tpu_torch.parallel import spatial

    monkeypatch.setattr(spatial, "composite_spatial", lambda layers, m, o, mesh=None: layers[-1])


def _one_byte_altered(monkeypatch):
    from paintfe_tpu_torch.core import composite as program

    faults.after(monkeypatch, program, "composite_stack_static", faults.flip_one_byte)


# one image a request: no batch to halve
FAULTS = {"state_unchanged": _state_unchanged, "one_byte_altered": _one_byte_altered}
