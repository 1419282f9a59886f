"""Live preview of the headline chain on a layered document:
`parallel.spatial.fused_chain_spatial(layer, overlay, rows_mesh, ...)`,
one request at a time, the active layer cycling through the document and
the overlay the layer above it; the chain's parameters of each request
drawn from the seed in the traffic's ranges.  The document lies on the
first card; the mesh has the traffic's `mesh_entries` cards.

SMALL and FAULTS serve the benchmark's tests: the configuration's sizes
for a CPU run of a few ms, and the ways the timed path can break, each a
fn(monkeypatch) that breaks it underneath (MESH_FAULTS: those that only a
mesh of two or more entries can have)."""

from __future__ import annotations

import dataclasses

import torch

from portbench import compare, faults, inputs
from portbench.reference import fused_chain, strips
from portbench.reference.numerics import gaussian_taps

# the tests' sizes: blocks of 20 rows on four entries, more than the halo
SMALL = {"width": 96, "height": 80}
PARAMS = ("brightness", "contrast", "black", "white", "gamma", "sepia_strength", "blend_opacity")


@dataclasses.dataclass
class State:
    cell: object
    layers: torch.Tensor
    covered: list
    mesh: object
    start: int


def setup(cell) -> State:
    from paintfe_tpu_torch.parallel import spatial

    layers, covered = inputs.layered_document(cell.config, cell.devices[0], cell.seed)
    mesh = spatial.rows_mesh(cell.devices[:cell.traffic["mesh_entries"]])
    start = int(inputs.rng(cell.seed).integers(0, layers.shape[0] - 1))
    return State(cell, layers, covered, mesh, start)


def request_params(state: State, i: int):
    """Request i's active layer and chain parameters."""
    t = state.cell.traffic
    draw = inputs.rng(state.cell.seed, i)
    params = {k: float(draw.uniform(*t[k])) for k in PARAMS}
    active = (state.start + i) % (state.layers.shape[0] - 1)
    return active, dict(params, sigma=float(t["sigma"]))


def _reference(state: State, img, overlay, params, ft, join=False):
    """The chain's plain reference in row strips: (a, b, rows a..b) each, or
    joined into the whole image."""
    fn = strips.by_strips if join else strips.strips
    return fn(lambda a, b: fused_chain.apply(a, b, ft=ft, **params), (img, overlay),
              state.cell.traffic["strip_rows"], fused_chain.context_rows(params["sigma"]))


def call(state: State, i: int):
    active, params = request_params(state, i)
    img, overlay = state.layers[active], state.layers[active + 1]
    if state.cell.control:
        out = _reference(state, img, overlay, params, torch.bfloat16, join=True)
    else:
        from paintfe_tpu_torch.parallel import spatial

        out = spatial.fused_chain_spatial(img, overlay, state.mesh, **params)
    h, w = img.shape[:2]
    work = {"kchain": {"px": h * w, "taps": len(gaussian_taps(params["sigma"])),
                       "overlay_px": state.covered[active + 1]}}
    return out, {"pixels": h * w, "work": work, "active": active, "params": params}


def check(state: State, kept) -> dict:
    worst = 0 if kept else compare.NOTHING
    for _, out, info in kept:
        a = info["active"]
        img, overlay = state.layers[a], state.layers[a + 1]
        for lo, hi, want in _reference(state, img, overlay, info["params"], torch.float32):
            worst = max(worst, compare.max_abs_diff(out[lo:hi], want))
    return {"max_abs_diff": (worst, compare.LIMIT)}


def _state_unchanged(monkeypatch):
    from paintfe_tpu_torch.parallel import spatial

    monkeypatch.setattr(spatial, "fused_chain_spatial", lambda img, ov, mesh=None, **p: img)


def _one_byte_altered(monkeypatch):
    from paintfe_tpu_torch.ops import fused_chain

    faults.after(monkeypatch, fused_chain, "fused_chain_kernel", faults.flip_one_byte)


def _exchange_left_out(monkeypatch):
    """Each block's halo is its own edge row repeated, not its neighbours'
    rows: the exchange between entries left out."""
    from paintfe_tpu_torch.parallel import spatial

    real = spatial._halo_extend
    monkeypatch.setattr(spatial, "_halo_extend",
                        lambda block, r, up, down, axis=0: real(block, r, None, None, axis))


# one image a request: no batch to halve
FAULTS = {"state_unchanged": _state_unchanged, "one_byte_altered": _one_byte_altered}
MESH_FAULTS = {"exchange_left_out": _exchange_left_out}
