"""The port's spans and counters (utils/profiling.span, count, counts):
the spans of parallel/spatial and of the kernel wrappers under a torch
profiler, their kind (host operators, never device-timeline
annotations), nothing recorded without a profiler, the copy counters
against the arithmetic of each call's shapes and halo, and the kernels'
launch counts as entries of the one registry.  The last case needs a
card (marked `cuda`; it skips without one)."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from paintfe_tpu_torch.ops.filters import gaussian_kernel
from paintfe_tpu_torch.parallel import spatial
from paintfe_tpu_torch.utils import cuda_build, profiling
from paintfe_tpu_torch.utils.device import upload_shared

SIGMA = 2.0
R = (len(gaussian_kernel(SIGMA)) - 1) // 2  # 6: the chain's halo rows
W = 24


def _layers(n, h, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, h, W, 4), np.uint8))


def _chain(h, k, device="cpu", gamma=0.9):
    img, overlay = _layers(2, h, seed=h).to(device).unbind(0)
    return spatial.fused_chain_spatial(img, overlay, spatial.rows_mesh([torch.device(device)] * k),
                                       sigma=SIGMA, gamma=gamma)


def _composite(h, k, device="cpu"):
    layers = _layers(3, h, seed=h + 1).to(device)
    return spatial.composite_spatial(layers, [0, 3, 16], [1.0, 0.6, 0.3],
                                     spatial.rows_mesh([torch.device(device)] * k))


CALLS = {"chain": _chain, "composite": _composite}


def _traced(fn, device="cpu"):
    """fn() inside a request range under a torch profiler: the `pfe.`
    spans as (name, start, end, parent), parent the innermost `pfe.` span
    or the request range enclosing it on its thread; and the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function("request"):
            fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU
              and (e.name().startswith("pfe.") or e.name() == "request")]
    spans = []
    for name, a, b, th in events:
        if name == "request":
            continue
        outer = [(a2, n2) for n2, a2, b2, th2 in events
                 if th2 == th and a2 <= a and b <= b2 and (n2, a2, b2) != (name, a, b)]
        spans.append((name, a, b, max(outer)[1] if outer else None))
    return sorted(spans, key=lambda s: s[1]), prof


def _names(spans):
    out = {}
    for name, *_ in spans:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_spatial_calls_emit_their_spans_under_a_profiler(call, k):
    """Each step of a spatial call is one span under the caller's request
    range: the check once, one halo and overlay span a block (the chain),
    the layer list of each block's fold (the compositor on the CPU), the
    gather's two, the join once; padding (50 rows over 4 entries) and the
    blocks are the scatter.  The chain on one entry takes the
    single-device route: the check and the image's and overlay's
    scatter, which move nothing, alone."""
    h = 50
    spans, _ = _traced(lambda: CALLS[call](h, k))
    names = _names(spans)
    assert all(parent == "request" for *_, parent in spans), spans
    assert names["pfe.spatial.check"] == 1
    if call == "chain" and k == 1:
        assert [s[0] for s in spans if s[0].startswith("pfe.spatial.")] == \
            ["pfe.spatial.check", "pfe.spatial.scatter", "pfe.spatial.scatter"]
        return
    assert names["pfe.spatial.gather"] == 2
    assert names["pfe.spatial.join"] == 1
    pad = h % k != 0
    if call == "chain":
        assert names["pfe.spatial.halo"] == names["pfe.spatial.overlay"] == k
        assert names["pfe.spatial.scatter"] == 2 * k + 2 * pad
    else:
        assert names["pfe.kcomposite.prepare"] == k
        assert names["pfe.spatial.scatter"] == k + pad
    order = [s[0] for s in spans]
    assert order[0] == "pfe.spatial.check" and order[-1] == "pfe.spatial.join"


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_are_host_operators_never_annotations(call, tmp_path):
    """In the Chrome trace (what the CLI's --trace-dir writes) every
    `pfe.` event is a CPU operator: no user annotation, which torch would
    mirror onto the device timeline."""
    _, prof = _traced(lambda: CALLS[call](40, 2))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if str(e.get("name", "")).startswith("pfe.")}
    assert cats == {"cpu_op"}


def test_nothing_is_recorded_without_a_profiler():
    """With no profiler recording, a span is one shared null context, no
    event exists for a profiler started later, and only the totals count."""
    assert profiling.span("pfe.a") is profiling.span("pfe.b")
    traced, total = profiling.counts(traced=True), profiling.counts()
    for k in (1, 2):
        _chain(30, k)
        _composite(30, k)
    assert profiling.counts(traced=True) == traced
    after = profiling.counts()
    assert after["spatial.copy_bytes.join"] > total.get("spatial.copy_bytes.join", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("pfe.")]


def _copied(fn):
    """The spatial layer's copy counters that fn() moved, by step."""
    before = profiling.counts()
    fn()
    after = profiling.counts()
    return {name[len("spatial.copy_bytes."):]: n - before.get(name, 0)
            for name, n in after.items()
            if name.startswith("spatial.copy_bytes.") and n != before.get(name, 0)}


@pytest.mark.parametrize("h", [48, 50, 20])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_chain_copy_bytes_follow_shapes_and_halo(k, h):
    """K entries of hb = ceil(h / k) rows: a padded image and overlay when
    k does not divide h, a halo and an overlay block of hb + 2r rows each,
    the join of k blocks; one entry, and a block shorter than r, take the
    single-device route, where the image already lies on the entry: no
    copy at all."""
    row = W * 4
    hb = -(-h // k)
    got = _copied(lambda: _chain(h, k))
    if spatial.route(h, k, R) == "single-device":
        assert got == {}
        return
    want = {"halo": k * (hb + 2 * R) * row, "overlay": k * (hb + 2 * R) * row,
            "join": k * hb * row}
    if h % k:
        want["scatter"] = 2 * k * hb * row
    assert got == want


@pytest.mark.parametrize("h", [48, 50])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_composite_copy_bytes_follow_shapes(k, h):
    """The compositor has no halo: the zero rows that pad N layers to k
    blocks (when k does not divide h), then the join of k blocks; one
    entry's one block is the result, so one entry copies nothing."""
    row = W * 4
    hb = -(-h // k)
    want = {"join": k * hb * row} if k > 1 else {}
    if h % k:
        want["scatter"] = 3 * k * hb * row
    assert _copied(lambda: _composite(h, k)) == want


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_call_counts_its_route(call, k):
    """A spatial call counts its route once, `spatial.route.<route>`: the
    single-device route on one entry, the sharded one on two (blocks of
    24 rows hold the chain's halo of 6)."""
    before = profiling.counts()
    CALLS[call](48, k)
    moved = {name: n - before.get(name, 0) for name, n in profiling.counts().items()
             if name.startswith("spatial.route.") and n != before.get(name, 0)}
    assert spatial.route(48, k, R) == ("single-device" if k == 1 else "sharded")
    assert moved == {f"spatial.route.{spatial.route(48, k, R)}": 1}


def test_a_host_copy_to_send_counts_only_when_it_copies():
    """The gather's send buffer (spatial._to_host on the CPU): a block
    already contiguous is sent as it is, 0 bytes; a strided one is copied,
    its bytes counted as the gather's."""
    block = _layers(1, 8)[0]
    assert _copied(lambda: spatial._to_host(block)) == {}
    strided = block[:, ::2]
    assert _copied(lambda: spatial._to_host(strided)) == {"gather": 8 * (W // 2) * 4}


def test_upload_is_a_span_and_counts_one_upload():
    """utils/device.upload_shared: span `pfe.device.upload` and one
    upload, in the totals and, under a profiler, the traced counts."""
    table = np.arange(256, dtype=np.float32)
    before, traced = profiling.counts(), profiling.counts(traced=True)
    spans, _ = _traced(lambda: upload_shared(table, "cpu"))
    assert [(s[0], s[3]) for s in spans] == [("pfe.device.upload", "request")]
    for now, then in ((profiling.counts(), before), (profiling.counts(traced=True), traced)):
        assert now["device.uploads"] - then.get("device.uploads", 0) == 1


def test_launch_counts_are_entries_of_the_registry():
    """count_launch adds to the wrapper's `.launches`, the one store of its
    count, which counts() reads as `launches.<name>` and launch_counts()
    by name, a reset of `.launches` included; under a profiler the traced
    counts hold the launch too."""

    def probe_registry_kernel():
        cuda_build.count_launch(probe_registry_kernel)

    probe_registry_kernel.launches = 0
    probe_registry_kernel()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        probe_registry_kernel()
    assert probe_registry_kernel.launches == 2
    assert profiling.counts()["launches.probe_registry_kernel"] == 2
    assert profiling.counts(traced=True)["launches.probe_registry_kernel"] == 1
    assert cuda_build.launch_counts()["probe_registry_kernel"] == 2
    probe_registry_kernel.launches = 0
    assert profiling.counts()["launches.probe_registry_kernel"] == 0
    assert cuda_build.launch_counts()["probe_registry_kernel"] == 0
    assert cuda_build.LAUNCH_LOCK is profiling.COUNT_LOCK


def test_counts_lose_nothing_across_threads():
    """8 threads x 1,000 adds to one counter count 8,000, with the
    interpreter switching threads as often as it can."""
    name = "test.threads"
    start = profiling.counts().get(name, 0)
    go = threading.Event()

    def worker():
        go.wait()
        for _ in range(1000):
            profiling.count(name)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for th in threads:
            th.start()
        go.set()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert profiling.counts()[name] - start == 8000


@pytest.mark.cuda
def test_spans_stay_off_the_device_timeline():
    """On the card, under a CUDA profiler: the kernel wrappers' spans
    (K-chain's tables with the levels table's upload inside, its launch;
    K-composite's prepare and launch) are there, and no `pfe.` event has
    the CUDA device type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _chain(64, 2, "cuda")  # the library built and the taps cached before the trace
    gammas = iter([0.81, 0.82])  # a new levels table in each traced call: one upload

    def both():
        _chain(64, 2, "cuda", next(gammas))
        _composite(64, 2, "cuda")
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("request"):
            both()
    on_card = [e.name() for e in prof.profiler.kineto_results.events()
               if e.name().startswith("pfe.") and e.device_type() == torch.autograd.DeviceType.CUDA]
    assert on_card == []
    spans, _ = _traced(both, "cuda")
    names = _names(spans)
    assert names["pfe.kchain.tables"] == names["pfe.kchain.launch"] == 2
    assert names["pfe.kcomposite.prepare"] == names["pfe.kcomposite.launch"] == 2
    assert [p for n, *_, p in spans if n == "pfe.device.upload"] == ["pfe.kchain.tables"]
