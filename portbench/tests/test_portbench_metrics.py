"""The metrics' arithmetic on synthetic windows and device timelines, and
BENCHMARK.json resolving to its files by name."""

import json

import pytest

from portbench import harness, peaks, stats
from portbench.counts import kchain
from portbench.trace import DeviceOp, TraceView, breakdown

MS = 1_000_000  # ns


def _run(records, window_s, view=None, setup_s=1.0):
    return harness.Run(records=records, window_s=window_s, setup_s=setup_s, trace=view)


def _records(latencies_ms, pixels=1_000_000, work=None):
    return [harness.Record(ms, pixels, work or {}) for ms in latencies_ms]


def _metric(name):
    return harness.load_module("metrics", name)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    """Rate over all the window's work and time, tail over all requests:
    six stalled requests of a hundred move both, where a median of chunks
    would see none of them."""
    steady = _records([10.0] * 100)
    stalled = _records([10.0] * 94 + [200.0] * 6)
    rate, p95 = _metric("mpix_per_s"), _metric("edit_ms_p95")
    assert rate.read(_run(steady, 1.0)) == pytest.approx(100.0)
    assert rate.read(_run(stalled, 0.94 + 1.2)) == pytest.approx(100 / 2.14)
    assert p95.read(_run(steady, 1.0)) == 10.0
    assert p95.read(_run(stalled, 2.14)) == 200.0
    # a median of ten chunks of ten requests would read the steady rate
    chunks = sorted(10 / (sum(r.latency_ms for r in stalled[k:k + 10]) / 1e3)
                    for k in range(0, 100, 10))
    assert chunks[5] == pytest.approx(100.0)


def test_percentile_is_nearest_rank():
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19


def _view(ops, spans, devices=(0,)):
    return TraceView(ops=list(ops), spans=list(spans), host_ops=[], devices=list(devices))


def test_roofline_share_follows_from_counts_and_kernel_time():
    work = {"kchain": {"px": 16384 * 16384, "taps": 13, "overlay_px": 100_000_000}}
    records = _records([8.0, 8.0], work=work)
    least = peaks.least_s(kchain.ops(**work["kchain"]), kchain.nbytes(**work["kchain"]))
    ops = [DeviceOp(0, "void (anonymous namespace)::chain_tiled_kernel<4>(unsigned int const*)",
                    1 * MS, 8 * MS),
           DeviceOp(0, "void (anonymous namespace)::chain_tiled_kernel<4>(unsigned int const*)",
                    11 * MS, 18 * MS),
           DeviceOp(0, "void at::native::CatArrayBatchedCopy<...>", 8 * MS, 9 * MS)]
    view = _view(ops, [(0, 10 * MS), (10 * MS, 20 * MS)])
    got = _metric("kchain_roofline").read(_run(records, 0.02, view))
    assert got == pytest.approx(100 * 2 * least / 0.014)
    assert 0 < got < 100


def test_idle_comes_from_the_timeline():
    ops = [DeviceOp(0, "k", 0, 2 * MS), DeviceOp(0, "k", 1 * MS, 3 * MS),   # overlap: busy 0..3
           DeviceOp(0, "Memcpy HtoD (Pageable -> Device)", 6 * MS, 8 * MS),
           DeviceOp(1, "k", 0, 10 * MS)]
    view = _view(ops, [(0, 5 * MS), (5 * MS, 10 * MS)], devices=(0, 1))
    # card 0 busy 5 of 10 ms, card 1 all of it
    assert _metric("device_idle_pct").read(_run(_records([5, 5]), 0.01, view)) == pytest.approx(25.0)
    assert view.busy_s(0) == pytest.approx(0.005)
    # host share of the requests: wall minus any card busy inside each span
    assert _metric("edit_host_ms").read(_run(_records([5, 5]), 0.01, view)) == pytest.approx(0.0)
    gaps = breakdown(view)["idle_gaps"]
    assert [round(s, 6) for _, s in gaps] == [0.003, 0.002]
    assert stats.gaps(stats.merge([(0, 2), (1, 3), (6, 8)]), 0, 10) == [(3, 6), (8, 10)]


def test_spatial_copies_by_request():
    """Copies on and between cards and ATen's cats count; host copies and
    other kernels do not; a trace with device work and no such copy reads 0."""
    ops = [DeviceOp(0, "Memcpy HtoD (Pageable -> Device)", 0, 4 * MS),
           DeviceOp(0, "void at::native::vectorized_elementwise_kernel<4>", 4 * MS, 20 * MS),
           DeviceOp(0, "void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<...>",
                    20 * MS, 22 * MS),
           DeviceOp(0, "Memcpy DtoD (Device -> Device)", 22 * MS, 23 * MS),
           DeviceOp(0, "Memcpy PtoP (Device -> Device)", 30 * MS, 31 * MS)]
    view = _view(ops, [(0, 20 * MS), (20 * MS, 40 * MS)])
    run = _run(_records([20.0, 20.0]), 0.04, view)
    assert _metric("spatial_copy_ms_per_edit").read(run) == pytest.approx(2.0)
    plain = _run(_records([20.0, 20.0]), 0.04, _view(ops[:2], view.spans))
    assert _metric("spatial_copy_ms_per_edit").read(plain) == 0.0


@pytest.mark.parametrize("name", ["kchain_roofline", "kcomposite_roofline", "edit_host_ms",
                                  "spatial_copy_ms_per_edit", "device_idle_pct"])
def test_an_empty_trace_fails_the_metric(name):
    """A trace with no device events, or no trace, reads nothing: never 0."""
    work = {"kchain": {"px": 64, "taps": 13, "overlay_px": 0},
            "kcomposite": {"px": 64, "modes": [0], "runs_px": [64]}}
    records = [harness.Record(1.0, 64, work)]
    assert _metric(name).read(_run(records, 0.01, _view([], [(0, MS)]))) is None
    assert _metric(name).read(_run(records, 0.01, None)) is None


def test_benchmark_resolves_to_its_files():
    bench = harness.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        spec, config, traffic = harness.resolve(bench, w["name"])
        entry = harness.load_module("entries", traffic["entry"])
        assert all(callable(getattr(entry, f)) for f in ("setup", "call", "check"))
        assert any(c["name"] == w["config"] for c in bench["configs"])
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        config = json.loads((harness.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(config)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for cell in m["workloads"]:   # each cell that reports it reports what it moves
            moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", cells)


def test_kernel_names_are_the_programs():
    """The kernels a roofline reads are __global__ functions of csrc/."""
    names = harness.csrc_kernels()
    for metric in ("kchain_roofline", "kcomposite_roofline"):
        assert set(harness.load_module("metrics", metric).KERNELS) <= names
    assert {"chain_tiled_kernel", "composite_kernel", "median_net_kernel"} <= names


def test_a_per_layer_metric_lists_its_cells():
    """An end-to-end metric without a list is on every cell's line; a
    per-layer one has to list its cells."""
    assert harness.applies({"name": "setup_s"}, "any-cell")
    assert not harness.applies({"name": "p", "workloads": ["a"]}, "b")
    with pytest.raises(harness.CellError):
        harness.applies({"name": "p", "moves": "setup_s"}, "a")
