"""The comparison that decides `correct` fails what it has to: the
control (the reference in bfloat16 in the program's place) and the timed
path broken underneath in each way a cell can break, each driving the rest
of a run on the CPU at a small size (the look for a card skipped).  The
small sizes and the faults are the cell's entry's (`SMALL`, `FAULTS`, and
`MESH_FAULTS` where its mesh has two or more entries), so a new cell needs
no edit here."""

import json
import time

import pytest
import torch

from portbench import harness

SEEDS = (5, 2**31 + 7, 2**33 + 11)


def _cells():
    return [w["name"] for w in harness.benchmark()["workloads"]]


def _cell(cell):
    """The cell's BENCHMARK.json entry, traffic, and the entry module it drives."""
    spec, _, traffic = harness.resolve(harness.benchmark(), cell)
    return spec, traffic, harness.load_module("entries", traffic["entry"])


def _faults(cell):
    _, traffic, entry = _cell(cell)
    mesh = getattr(entry, "MESH_FAULTS", {}) if traffic.get("mesh_entries", 1) > 1 else {}
    return {**entry.FAULTS, **mesh}


def _run(cell, seed, control=False):
    spec, _, entry = _cell(cell)
    return harness.execute(cell, seed, 0.3, False, [torch.device("cpu")] * spec["chips"],
                           t0=time.perf_counter(), control=control, overrides=entry.SMALL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", _cells())
def test_program_is_correct_and_control_is_not(cell, seed):
    ok = _run(cell, seed)
    assert ok["correct"], ok["checks"]
    assert ok["checks"]["max_abs_diff"]["value"] == 0
    bad = _run(cell, seed, control=True)
    assert not bad["correct"]
    assert bad["checks"]["max_abs_diff"]["value"] >= 1


@pytest.mark.parametrize("cell, fault", [(c, f) for c in _cells() for f in sorted(_faults(c))],
                         ids=lambda v: v)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    _faults(cell)[fault](monkeypatch)
    got = _run(cell, SEEDS[0])
    assert not got["correct"], got["checks"]


def test_every_entry_a_traffic_names_has_small_sizes_and_faults():
    """What the two tests above take from a cell's entry, for every
    traffic file, in BENCHMARK.json or not yet."""
    for path in sorted((harness.BENCH / "traffic").glob("*.json")):
        entry = harness.load_module("entries", json.loads(path.read_text())["entry"])
        assert isinstance(entry.SMALL, dict) and entry.SMALL, path.name
        assert entry.FAULTS and all(callable(f) for f in entry.FAULTS.values()), path.name
        assert all(callable(f) for f in getattr(entry, "MESH_FAULTS", {}).values()), path.name
