"""The port's runtime utilities (paintfe_tpu_torch.utils: i18n, logger,
settings, autosave, profiling, printing, runtime_services) against the JAX
package's, case by case as tests/test_aux.py and the print, single-instance
and keybindings cases of tests/test_runtime_services.py run them, on the
same inputs at tolerance 0; the files both packages write (autosave .pfe,
settings JSON, print PNG) byte for byte; the three entry points whose
default device became the card; the kernels' launch counters across
threads; DoubleBuffer's hand-off of items made on a CUDA stream."""

import json
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paintfe_tpu.core import fixtures as jfixtures
from paintfe_tpu.core.blend import BlendMode as JBlendMode
from paintfe_tpu.core.canvas import Canvas as JCanvas
from paintfe_tpu.core.canvas import Layer as JLayer
from paintfe_tpu.io import codecs as jcodecs
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu.utils import i18n as ji18n
from paintfe_tpu.utils import logger as jlogger
from paintfe_tpu.utils import printing as jprinting
from paintfe_tpu.utils import profiling as jprofiling
from paintfe_tpu.utils import runtime_services as jrs
from paintfe_tpu.utils.autosave import Autosaver as JAutosaver
from paintfe_tpu.utils.settings import AppSettings as JAppSettings
from paintfe_tpu_torch.core import fixtures
from paintfe_tpu_torch.core.blend import BlendMode
from paintfe_tpu_torch.core.canvas import Canvas, Layer
from paintfe_tpu_torch.io import codecs, pfe
from paintfe_tpu_torch.parallel.prefetch import DoubleBuffer
from paintfe_tpu_torch.utils import i18n, logger, printing, profiling
from paintfe_tpu_torch.utils import runtime_services as rs
from paintfe_tpu_torch.utils.autosave import Autosaver
from paintfe_tpu_torch.utils.settings import AppSettings

# --- i18n ------------------------------------------------------------------


def test_i18n_lookup_and_fallback():
    for mod in (ji18n, i18n):
        mod.init()
        mod.set_language("en")
        assert mod.t("interpolation.bilinear") == "Bilinear"
        mod.set_language("fr")
        assert mod.t("interpolation.bilinear") == "Bilinéaire"
        mod._state["translations"]["xx"] = {"interpolation.bilinear": "Xx"}
        mod.set_language("xx")
        assert mod.t("interpolation.bilinear") == "Xx"
        assert mod.t("quality.instant") == "Instant"
        assert mod.t("no.such.key") == "no.such.key"
        del mod._state["translations"]["xx"]
        mod.set_language("en")


def test_i18n_parse():
    text = "# comment\na.b=Hello\n\nc.d=World=X\n"
    assert i18n.parse_translations(text) == ji18n.parse_translations(text) \
        == {"a.b": "Hello", "c.d": "World=X"}


def test_i18n_value_trimmed():
    text = "menu.file = File\nmenu.edit=Edit  \n"
    assert i18n.parse_translations(text) == ji18n.parse_translations(text) \
        == {"menu.file": "File", "menu.edit": "Edit"}


def test_i18n_all_locales_complete():
    """All 15 languages ship in the port's own locales/, byte-equal to the
    JAX package's, with identical key sets; t() gives the JAX package's
    string for every key of every language."""
    assert i18n._LOCALES_DIR != ji18n._LOCALES_DIR
    assert i18n._LOCALES_DIR.parent.name == "paintfe_tpu_torch"
    assert i18n.LANGUAGES == ji18n.LANGUAGES and len(i18n.LANGUAGES) == 15
    key_sets = {}
    for code, _ in i18n.LANGUAGES:
        path = i18n._LOCALES_DIR / f"{code}.txt"
        assert path.read_bytes() == (ji18n._LOCALES_DIR / f"{code}.txt").read_bytes()
        key_sets[code] = set(i18n.parse_translations(path.read_text(encoding="utf-8")))
    assert len(key_sets["en"]) > 600
    assert all(keys == key_sets["en"] for keys in key_sets.values())
    i18n.init()
    ji18n.init()
    for code, _ in i18n.LANGUAGES:
        i18n.set_language(code)
        ji18n.set_language(code)
        assert [i18n.t(k) for k in sorted(key_sets["en"])] == \
            [ji18n.t(k) for k in sorted(key_sets["en"])], code
    i18n.set_language("fe")
    assert i18n.t("tool.magic_wand") == "The Enchanted Wand"
    i18n.set_language("en")
    ji18n.set_language("en")


# --- logger -------------------------------------------------------------------


def test_logger_truncates_per_session(tmp_path):
    for tag, mod in (("jax", jlogger), ("port", logger)):
        p = tmp_path / f"{tag}.log"
        mod.init(p)
        mod.log_info("first session")
        assert "first session" in p.read_text()
        mod.init(p)  # relaunch truncates
        mod.log_warn("second")
        mod.log_err("third")
        text = p.read_text()
        assert "first session" not in text and "second" in text
        assert "[WARN]" in text
    line = re.compile(r"^\[\d\d:\d\d:\d\d\.\d{3}\] \[(INFO|WARN|ERROR)\] .*$")
    jl, tl = ((tmp_path / f"{t}.log").read_text().splitlines() for t in ("jax", "port"))
    assert all(line.match(x) for x in jl + tl)
    assert [x[15:] for x in tl] == [x[15:] for x in jl]  # after the timestamp
    assert logger.default_log_dir() == jlogger.default_log_dir()


def test_logger_reinit_closes_previous(tmp_path):
    logger.init(tmp_path / "a.log")
    first = logger._file
    logger.init(tmp_path / "b.log")
    assert first.closed
    logger.write_line("x")
    assert (tmp_path / "b.log").read_text() == "x\n"


# --- settings -----------------------------------------------------------------


def test_settings_roundtrip_and_defaults(tmp_path):
    p = tmp_path / "settings.json"
    s = AppSettings()
    s.jpeg_quality = 75
    s.language = "fr"
    s.save(p)
    loaded = AppSettings.load(p)
    assert loaded.jpeg_quality == 75 and loaded.language == "fr"
    p.write_text(json.dumps({"jpeg_quality": 42, "未知": True}))
    loaded = AppSettings.load(p)
    assert loaded.jpeg_quality == 42
    assert loaded.webp_lossless is True
    assert vars(loaded) == vars(JAppSettings.load(p))


def test_settings_load_missing_file(tmp_path):
    s = AppSettings.load(tmp_path / "nope.json")
    assert s.autosave_interval_minutes == 5
    assert vars(s) == vars(JAppSettings.load(tmp_path / "nope.json"))


def test_settings_load_rejects_mistyped_fields(tmp_path):
    p = tmp_path / "settings.json"
    p.write_text(json.dumps({"autosave_interval_minutes": "5", "recent_files": "a.png",
                             "theme": 3, "default_background": [1, 2, 3],
                             "max_recent_files": 2.5, "brush_size": 7}))
    s, d = AppSettings.load(p), AppSettings()
    assert s.autosave_interval_minutes == d.autosave_interval_minutes
    assert s.recent_files == d.recent_files
    assert s.theme == d.theme
    assert s.default_background == d.default_background
    assert s.brush_size == 7.0 and isinstance(s.brush_size, float)
    assert vars(s) == vars(JAppSettings.load(p))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_settings_json_shared_between_packages(tmp_path, writer):
    """A settings file written by one package loads field for field in the
    other, and both write the same bytes; the same config directory."""
    make = JAppSettings if writer == "jax" else AppSettings
    s = make()
    s.language, s.jpeg_quality, s.recent_files = "ja", 61, ["a.png", "b.pfe"]
    s.default_background = (1, 2, 3, 4)
    s.brush_size = 3.5
    s.save(tmp_path / "settings.json")
    loaded = (AppSettings if writer == "jax" else JAppSettings).load(tmp_path / "settings.json")
    assert vars(loaded) == vars(s)
    other = (AppSettings if writer == "jax" else JAppSettings)()
    for k, v in vars(s).items():
        setattr(other, k, v)
    other.save(tmp_path / "again.json")
    assert (tmp_path / "again.json").read_bytes() == (tmp_path / "settings.json").read_bytes()
    from paintfe_tpu.utils import settings as jsettings
    from paintfe_tpu_torch.utils import settings as tsettings

    assert tsettings.default_config_dir() == jsettings.default_config_dir()
    assert tsettings.default_config_dir().name == "PaintFE-TPU"
    assert [f.name for f in __import__("dataclasses").fields(AppSettings)] == \
        [f.name for f in __import__("dataclasses").fields(JAppSettings)]


# --- autosave -----------------------------------------------------------------


def _docs(w, h):
    """The same two-layer fixture document in both packages."""
    base, top = fixtures.test_gradient(w, h), fixtures.blend_test_foreground(w, h)
    np.testing.assert_array_equal(base, jfixtures.test_gradient(w, h))
    jdoc = JCanvas.from_image(base)
    jtop = JLayer(name="fg", pixels=top.copy())
    jtop.blend_mode, jtop.opacity = JBlendMode.OVERLAY, 0.7
    jdoc.layers.append(jtop)
    doc = Canvas.from_image(base)
    ttop = Layer(name="fg", pixels=top.copy())
    ttop.blend_mode, ttop.opacity = BlendMode.OVERLAY, 0.7
    doc.layers.append(ttop)
    return jdoc, doc


def test_autosave_roundtrip(tmp_path):
    c = Canvas.from_image(fixtures.test_gradient(32, 32))
    saver = Autosaver(interval_minutes=5.0, directory=tmp_path)
    path = saver.save_now(c, "proj")
    assert path is not None and path.exists()
    back = pfe.load_pfe(str(path))
    np.testing.assert_array_equal(back.layers[0].pixels, c.layers[0].pixels)
    assert saver.list_autosaves() == [path]
    assert Autosaver(directory=tmp_path / "none").list_autosaves() == []


def test_autosave_equals_jax_autosave(tmp_path):
    jdoc, doc = _docs(70, 45)
    jpath = JAutosaver(directory=tmp_path / "jax").save_now(jdoc, "my doc")
    path = Autosaver(directory=tmp_path / "port").save_now(doc, "my doc")
    assert path.name == jpath.name == "my_doc.autosave.pfe"
    assert path.read_bytes() == jpath.read_bytes()
    back = jpfe.load_pfe(str(path))
    np.testing.assert_array_equal(back.layers[1].pixels, doc.layers[1].pixels)


def test_autosave_interval_semantics(tmp_path):
    c = Canvas.from_image(fixtures.test_gradient(8, 8))
    disabled = Autosaver(interval_minutes=0.0, directory=tmp_path)
    assert disabled.maybe_save(c, "off") is None
    fresh = Autosaver(interval_minutes=5.0, directory=tmp_path)
    assert fresh.maybe_save(c, "fresh") is None
    fresh.last_save -= 301.0
    assert fresh.maybe_save(c, "fresh") is not None
    assert fresh.maybe_save(c, "fresh") is None  # the interval starts again
    assert [p.name for p in fresh.list_autosaves()] == ["fresh.autosave.pfe"]


def test_autosave_sanitizes_project_name(tmp_path):
    c = Canvas.from_image(fixtures.test_gradient(8, 8))
    path = Autosaver(interval_minutes=5.0, directory=tmp_path).save_now(c, "my/evil..name!")
    jpath = JAutosaver(interval_minutes=5.0, directory=tmp_path / "j").save_now(
        JCanvas.from_image(jfixtures.test_gradient(8, 8)), "my/evil..name!")
    assert path.parent == tmp_path
    assert path.name == jpath.name == "my_evil__name_.autosave.pfe"


# --- profiling ----------------------------------------------------------------


def test_stage_timer():
    t = profiling.StageTimer("cpu")
    with t.stage("load"):
        pass
    with t.stage("process"):
        pass
    with t.stage("load"):
        pass
    totals = t.totals()
    assert set(totals) == {"load", "process"}
    assert totals["load"] == t.stages[0][1] + t.stages[2][1]
    assert "load" in t.report()
    jt = jprofiling.StageTimer()
    jt.stages = list(t.stages)
    assert jt.totals() == totals and jt.report() == t.report()


def test_stage_timer_blocks_on_handle_result():
    t = profiling.StageTimer("cpu")
    with t.stage("compute") as h:
        h.result = torch.ones((8, 8)) * 2.0
    with t.stage("callable", block_on=lambda: torch.zeros(2)):
        pass
    with t.stage("value", block_on=torch.zeros(2)):
        pass
    assert set(t.totals()) == {"compute", "callable", "value"}


def test_fps_ring():
    ring, jring = profiling.FpsRing(size=4), jprofiling.FpsRing(size=4)
    assert ring.fps() == 0.0 and profiling.FpsRing().size == 60
    for _ in range(6):
        ring.tick()
    assert len(ring.samples) == 4
    assert ring.fps() > 0
    jring.samples = list(ring.samples)
    assert jring.fps() == ring.fps()


# --- the card as every entry point's default ------------------------------------


@pytest.mark.parametrize("entry", ["StageTimer", "dents_field", "halftone_threshold"])
def test_entry_defaults_to_card(monkeypatch, entry):
    """Without device=, each runs on the card, and raises on a machine
    without one; device="cpu" runs."""
    from paintfe_tpu_torch.ops.effects import distort, stylize

    calls = {"StageTimer": lambda **kw: profiling.StageTimer(**kw),
             "dents_field": lambda **kw: distort.dents_field(
                 24.0, 0.6, 7, 2, 0.5, True, False, 12, 16, **kw),
             "halftone_threshold": lambda **kw: stylize.halftone_threshold(
                 6.0, 45.0, stylize.HalftoneShape.CIRCLE, 12, 16, **kw)}
    calls[entry](device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_launch_counter_is_thread_safe():
    """8 threads x 1,000 counted launches of a plain stub count 8,000, with
    the interpreter switching threads as often as it can.  The stub's count
    is read and written through Python calls, where the interpreter may
    switch threads between the read and the write: without the lock, runs
    of this test lost about half the counts."""
    from paintfe_tpu_torch.utils.cuda_build import LAUNCH_LOCK, count_launch

    class Stub:
        def __init__(self):
            self._n = 0

        @property
        def launches(self):
            return self._n

        @launches.setter
        def launches(self, n):
            self._n = n

        def __call__(self):
            count_launch(self)

    stub = Stub()
    go = threading.Event()

    def worker():
        go.wait()
        for _ in range(1000):
            stub()

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
    with LAUNCH_LOCK:
        assert stub.launches == 8000


def test_launch_counts_name_each_counted_wrapper():
    """launch_counts() (what a multi-process CLI run reports under -v) holds
    every wrapper that counted a launch in this process, by name, at its
    count; a wrapper that never launched is absent."""
    from paintfe_tpu_torch.utils.cuda_build import count_launch, launch_counts

    def probe_kernel_a():
        count_launch(probe_kernel_a)

    def probe_kernel_b():
        count_launch(probe_kernel_b)

    probe_kernel_a.launches = probe_kernel_b.launches = 0
    assert "probe_kernel_a" not in launch_counts()
    for _ in range(3):
        probe_kernel_a()
    counts = launch_counts()
    assert counts["probe_kernel_a"] == 3 and "probe_kernel_b" not in counts
    probe_kernel_b()
    assert launch_counts()["probe_kernel_b"] == 1


# --- DoubleBuffer on CUDA-stream items ----------------------------------------


class _FakeEvent:
    log = []

    def record(self):
        self.thread = threading.get_ident()
        _FakeEvent.log.append(("record", self))


class _FakeStream:
    def wait_event(self, ev):
        _FakeEvent.log.append(("wait", ev))


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's events and streams as recorders, so the hand-off of a
    staged item runs here without a card."""
    _FakeEvent.log = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    return _FakeEvent.log


def test_double_buffer_stream_items_in_order(fake_cuda):
    """Item i >= 1 is made on the staging thread; an event recorded there
    after produce(i) is waited on by the consumer's stream before the item
    is yielded, once an item; no other wait."""
    consumer = threading.get_ident()
    made = []

    def produce(i):
        made.append((i, threading.get_ident()))
        time.sleep(0.002)
        return torch.full((3, 5, 4), i, dtype=torch.uint8)

    got = []
    for item in DoubleBuffer(produce, 6):
        got.append(int(item[0, 0, 0]))
        waits = [ev for kind, ev in fake_cuda if kind == "wait"]
        assert len(waits) == max(len(got) - 1, 0)  # waited before the yield
    assert got == list(range(6))
    assert made[0] == (0, consumer)
    assert all(t != consumer for _, t in made[1:])
    records = [ev for kind, ev in fake_cuda if kind == "record"]
    waits = [ev for kind, ev in fake_cuda if kind == "wait"]
    assert records == waits and len(waits) == 5
    assert all(ev.thread != consumer for ev in records)
    assert DoubleBuffer(produce, 1) is not None and list(DoubleBuffer(produce, 0)) == []


def test_double_buffer_stream_items_reraise(fake_cuda):
    def produce(i):
        if i == 3:
            raise ValueError("stage 3 failed")
        return torch.full((2, 2, 4), i, dtype=torch.uint8)

    got = []
    with pytest.raises(ValueError, match="stage 3 failed"):
        for item in DoubleBuffer(produce, 6):
            got.append(int(item[0, 0, 0]))
    assert got == [0, 1, 2]
    # the failed item recorded no event and none was waited on for it
    assert sum(kind == "wait" for kind, _ in fake_cuda) == 2


# --- runtime services -----------------------------------------------------------


def test_print_saves_composite(tmp_path, monkeypatch):
    import tempfile

    img = fixtures.test_gradient(16, 16)
    opened = []
    path = rs.print_image(torch.from_numpy(img), opener=opened.append)
    assert opened == [path] and path.exists()
    np.testing.assert_array_equal(codecs.load_image(path, device="cpu"), img)
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    port = printing.print_image(img).read_bytes()
    assert port == jprinting.print_image(jfixtures.test_gradient(16, 16)).read_bytes()
    assert printing.print_image(torch.from_numpy(img)).read_bytes() == port
    np.testing.assert_array_equal(jcodecs.load_image(tmp_path / "paintfe_print.png"), img)


def test_single_instance_forwarding(tmp_path):
    sock = str(tmp_path / "si.sock")
    primary = rs.SingleInstance(sock)
    assert primary.try_acquire()
    secondary = rs.SingleInstance(sock)
    assert not secondary.try_acquire()
    # the JAX package's client speaks the same protocol to the port's primary
    assert jrs.SingleInstance(sock).forward_files(["/a.png"])
    assert secondary.forward_files(["/b.png", "/c.png"])
    deadline = time.time() + 5
    while len(primary.received) < 3 and time.time() < deadline:
        time.sleep(0.05)
    assert primary.received == ["/a.png", "/b.png", "/c.png"]
    primary.release()
    secondary.release()
    assert rs.SingleInstance(str(tmp_path / "x.sock")).socket_path.endswith("x.sock")
    assert rs.SingleInstance().socket_path == jrs.SingleInstance().socket_path


def test_single_instance_large_forward(tmp_path):
    sock = str(tmp_path / "one.sock")
    primary = rs.SingleInstance(sock)
    assert primary.try_acquire()
    try:
        paths = [f"/very/long/path/number/{i:06d}.png" for i in range(3000)]
        secondary = rs.SingleInstance(sock)
        assert not secondary.try_acquire()
        assert secondary.forward_files(paths)
        deadline = time.time() + 10
        while len(primary.received) < len(paths) and time.time() < deadline:
            time.sleep(0.05)
        assert primary.received == paths
    finally:
        primary.release()


def test_single_instance_stale_socket_recovered(tmp_path):
    """A socket file left by a crashed primary is taken over."""
    import socket

    path = str(tmp_path / "stale.sock")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.close()  # the file stays, nobody listens
    inst = rs.SingleInstance(path)
    try:
        assert inst.try_acquire()
    finally:
        inst.release()


def test_keybindings_roundtrip(tmp_path):
    kb = rs.Keybindings()
    assert kb.action_for("ctrl+z") == "edit.undo"
    assert kb.action_for("Ctrl+Q") is None
    kb.rebind("edit.undo", "Ctrl+Alt+Z")
    p = tmp_path / "keys.json"
    kb.save(p)
    loaded = rs.Keybindings.load(p)
    assert loaded.bindings["edit.undo"] == "Ctrl+Alt+Z"
    assert loaded.bindings["file.save"] == rs.DEFAULT_KEYBINDINGS["file.save"]
    assert rs.Keybindings.load(tmp_path / "missing.json").bindings == rs.DEFAULT_KEYBINDINGS
    assert rs.DEFAULT_KEYBINDINGS == jrs.DEFAULT_KEYBINDINGS
    assert jrs.Keybindings.load(p).bindings == loaded.bindings
    jkb = jrs.Keybindings()
    jkb.rebind("edit.undo", "Ctrl+Alt+Z")
    jkb.save(tmp_path / "j.json")
    assert (tmp_path / "j.json").read_bytes() == p.read_bytes()
