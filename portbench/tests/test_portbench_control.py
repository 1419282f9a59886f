"""The comparison that decides `correct` fails what it has to: the
control (the reference in bfloat16 in the program's place) and the timed
path broken underneath in each way a cell can break, each driving the rest
of a run on the CPU at a small size (the look for a card skipped)."""

import time

import pytest
import torch

from portbench import harness

SMALL = {"cap16k-chain": {"width": 96, "height": 80},
         "cap16k-flatten": {"width": 64, "height": 48}}
SEEDS = (5, 2**31 + 7, 2**33 + 11)


def _cells():
    return [w["name"] for w in harness.benchmark()["workloads"]]


def _run(cell, seed, control=False):
    chips = next(w["chips"] for w in harness.benchmark()["workloads"] if w["name"] == cell)
    return harness.execute(cell, seed, 0.3, False, [torch.device("cpu")] * chips,
                           t0=time.perf_counter(), control=control, overrides=SMALL[cell])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", _cells())
def test_program_is_correct_and_control_is_not(cell, seed):
    ok = _run(cell, seed)
    assert ok["correct"], ok["checks"]
    assert ok["checks"]["max_abs_diff"]["value"] == 0
    bad = _run(cell, seed, control=True)
    assert not bad["correct"]
    assert bad["checks"]["max_abs_diff"]["value"] >= 1


def _flip(out):
    out = out.clone()
    out.view(-1)[out.numel() // 3] ^= 1
    return out


def _state_unchanged(monkeypatch, cell):
    from paintfe_tpu_torch.parallel import spatial

    if cell == "cap16k-flatten":
        monkeypatch.setattr(spatial, "composite_spatial", lambda layers, m, o, mesh=None: layers[-1])
    else:
        monkeypatch.setattr(spatial, "fused_chain_spatial", lambda img, ov, mesh=None, **p: img)


def _one_byte_altered(monkeypatch, cell):
    from paintfe_tpu_torch.core import composite
    from paintfe_tpu_torch.ops import fused_chain

    if cell == "cap16k-flatten":
        real = composite.composite_stack_static
        monkeypatch.setattr(composite, "composite_stack_static", lambda *a, **k: _flip(real(*a, **k)))
    else:
        real = fused_chain.fused_chain_kernel
        monkeypatch.setattr(fused_chain, "fused_chain_kernel", lambda *a, **k: _flip(real(*a, **k)))


# the faults a cell of one image on one card can have (no batch to halve,
# no exchange between cards to leave out)
FAULTS = {"state_unchanged": _state_unchanged, "one_byte_altered": _one_byte_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", _cells())
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    got = _run(cell, SEEDS[0])
    assert not got["correct"], got["checks"]
