"""The readers of the program's spans and counters (portbench/spans.py
and the five metrics on them) on synthetic traces and counter sets."""

import pytest

from portbench import harness, spans
from portbench.trace import DeviceOp, TraceView

MS = 1_000_000  # ns
IDLE = ("idle_ms_per_edit.spatial", "idle_ms_per_edit.kernels", "idle_ms_per_edit.outside")
COUNTED = ("spatial_copy_bytes_per_edit", "table_uploads_per_edit")


def _metric(name):
    return harness.load_module("metrics", name)


def _run(view):
    records = [harness.Record(1.0, 64, {}) for _ in (view.spans if view else [None])]
    return harness.Run(records=records, window_s=0.02, setup_s=1.0, trace=view)


def _view(ops, requests, host_ops=(), devices=(0,)):
    return TraceView(ops=[DeviceOp(d, "k", a * MS, b * MS) for d, a, b in ops],
                     spans=[(a * MS, b * MS) for a, b in requests],
                     host_ops=[(n, a * MS, b * MS) for n, a, b in host_ops],
                     devices=list(devices))


# Two requests of 10 ms.  Request 1: the card busy 3..6; the host in the
# spatial check 0..2, a halo 2..3, K-chain's tables 6..9 with an upload
# 7..8 inside, then nothing 9..10.  Request 2: busy 12..18, the join
# 18..20 with a cudaMalloc under it (not a span of ours).
OPS = [(0, 3, 6), (0, 12, 18)]
REQUESTS = [(0, 10), (10, 20)]
HOST = [("pfe.spatial.check", 0, 2), ("aten::repeat", 2, 3), ("pfe.spatial.halo", 2, 3),
        ("pfe.kchain.tables", 6, 9), ("pfe.device.upload", 7, 8),
        ("pfe.spatial.join", 18, 20), ("cudaMalloc", 18.5, 19.5)]


def test_idle_is_split_at_span_boundaries_and_charged_to_the_innermost():
    """Idle 0..3 and 10..12 before the card starts, 6..10 and 18..20 after:
    the spatial spans take 0..3 and 18..20, K-chain's tables and the upload
    inside them 6..9, nothing 9..10 and 10..12."""
    split = spans.idle_by_layer(_view(OPS, REQUESTS, HOST))
    assert split == {"spatial": 5 * MS, "kernels": 3 * MS, "outside": 3 * MS}
    run = _run(_view(OPS, REQUESTS, HOST))
    got = [_metric(n).read(run) for n in IDLE]
    assert got == pytest.approx([2.5, 1.5, 1.5])


def test_the_default_table_is_layers():
    """Passing spans.LAYERS, or nothing, reads what the metrics read."""
    view = _view(OPS, REQUESTS, HOST)
    assert spans.idle_by_layer(view, spans.LAYERS) == spans.idle_by_layer(view)
    assert spans.idle_by_layer(view) == {"spatial": 5 * MS, "kernels": 3 * MS,
                                         "outside": 3 * MS}
    run = _run(view)
    for layer in ("spatial", "kernels", "outside"):
        assert (spans.idle_ms_per_edit(run, layer, spans.LAYERS)
                == spans.idle_ms_per_edit(run, layer)
                == _metric(f"idle_ms_per_edit.{layer}").read(run))


def test_a_metric_can_charge_idle_to_a_table_of_its_own():
    """A `pfe.kmedian.` span: a table that names it takes its idle time;
    the default table, which does not, charges it outside."""
    host = HOST + [("pfe.kmedian.launch", 10, 11.5)]
    view = _view(OPS, REQUESTS, host)
    own = {"median": ("pfe.kmedian.",), **spans.LAYERS}
    assert spans.idle_by_layer(view, own) == {"median": 1.5 * MS, "spatial": 5 * MS,
                                              "kernels": 3 * MS, "outside": 1.5 * MS}
    assert spans.idle_by_layer(view) == {"spatial": 5 * MS, "kernels": 3 * MS,
                                         "outside": 3 * MS}
    run = _run(view)
    assert spans.idle_ms_per_edit(run, "median", own) == pytest.approx(0.75)
    assert spans.idle_ms_per_edit(run, "outside") == pytest.approx(1.5)


def test_innermost_pieces_follow_the_nesting():
    pieces = spans.innermost([("pfe.a", 0, 10), ("pfe.b", 2, 4), ("x", 3, 9),
                              ("pfe.c", 4, 6), ("pfe.d", 12, 13)])
    assert pieces == [(0, 2, "pfe.a"), (2, 4, "pfe.b"), (4, 6, "pfe.c"), (6, 10, "pfe.a"),
                      (12, 13, "pfe.d")]


def test_the_three_parts_sum_to_edit_host_ms_on_one_card():
    run = _run(_view(OPS, REQUESTS, HOST))
    parts = sum(_metric(n).read(run) for n in IDLE)
    assert parts == pytest.approx(_metric("edit_host_ms").read(run))


def test_a_trace_without_program_spans_is_all_outside():
    """The parent program opens no `pfe.` span: 0, 0, and the whole idle
    time outside, which is edit_host_ms."""
    run = _run(_view(OPS, REQUESTS, [("aten::repeat", 2, 3), ("cudaMalloc", 18, 19)]))
    spatial, kernels, outside = (_metric(n).read(run) for n in IDLE)
    assert (spatial, kernels) == (0.0, 0.0)
    assert outside == pytest.approx(_metric("edit_host_ms").read(run)) == pytest.approx(5.5)


def test_counters_over_the_window_requests(monkeypatch):
    counts = {"spatial.copy_bytes.halo": 2_049_536_000, "spatial.copy_bytes.overlay": 2_049_536_000,
              "spatial.copy_bytes.join": 2_048_000_000, "device.uploads": 2,
              "spatial.copy_bytes_other": 2048, "launches.fused_chain_kernel": 2}
    monkeypatch.setattr(spans, "traced_counts", lambda: counts)
    run = _run(_view(OPS, REQUESTS, HOST))
    assert _metric("spatial_copy_bytes_per_edit").read(run) == pytest.approx(3073.536)
    assert _metric("table_uploads_per_edit").read(run) == 1.0


def test_no_counters_read_zero(monkeypatch):
    monkeypatch.setattr(spans, "traced_counts", lambda: {})
    run = _run(_view(OPS, REQUESTS, HOST))
    assert [_metric(n).read(run) for n in COUNTED] == [0.0, 0.0]


def test_a_program_without_the_registry_reads_zero(monkeypatch):
    """A program whose profiling module has no counts() (the parent's)."""
    import paintfe_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "counts")
    assert spans.traced_counts() == {}


@pytest.mark.parametrize("name", IDLE + COUNTED)
def test_no_trace_reads_nothing(name):
    assert _metric(name).read(_run(None)) is None
