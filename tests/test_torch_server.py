"""The port's serving daemon (paintfe_tpu_torch.server) and prefetch loader
against the JAX package's: the five cases of tests/test_server.py, run on
the port with device="cpu"; the same job files through the JAX server and
the port's server giving the same output bytes (the headline and spatial
scripts, a layered .pfe to PNG and to .pfe); _ScriptCache's eviction; two
concurrent clients giving the serial bytes; the server defaulting to the
card and refusing --device cuda without one."""

import json
import socket
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from paintfe_tpu import server as jsrv
from paintfe_tpu.core.blend import BlendMode as JBlendMode
from paintfe_tpu.core.canvas import Canvas as JCanvas
from paintfe_tpu.core.canvas import Layer as JLayer
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu_torch import server as srv
from paintfe_tpu_torch.core import fixtures
from paintfe_tpu_torch.io import codecs

HEADLINE = ("apply_blur(2.0); apply_brightness_contrast(10.0, 20.0); "
            "apply_levels(10.0, 245.0, 1.1); apply_sepia(0.5);")
SPATIAL = ("apply_blur(2.0); apply_median(2); apply_bulge(0.5); "
           "apply_levels(10.0, 245.0, 1.1);")
LAYERED = "apply_blur(2.0); rotate_canvas_180(); flip_canvas_horizontal();"


def _start(module, **kw):
    s, port = module.serve_tcp(port=0, **kw)
    t = threading.Thread(target=s.serve_forever, daemon=True)
    t.start()
    return s, port, t


@pytest.fixture
def running_server():
    s, port, _ = _start(srv, device="cpu")
    yield port
    s.shutdown()
    s.server_close()


def _save(img, path):
    codecs.save_image(img, path, "png")
    return path


# --- the five cases of tests/test_server.py -------------------------------------


def test_server_processes_jobs_and_stays_warm(running_server, tmp_path):
    port = running_server
    img = fixtures.test_gradient(16, 16)
    src = _save(img, tmp_path / "in.png")
    script = tmp_path / "fx.rhai"
    script.write_text("apply_invert();")
    r1 = srv.request(port, {"input": str(src), "output": str(tmp_path / "o1.png"),
                            "script": str(script)})
    assert r1["ok"], r1
    assert r1["output"] == str(tmp_path / "o1.png") and isinstance(r1["elapsed_ms"], int)
    out = codecs.load_image(tmp_path / "o1.png", device="cpu")
    np.testing.assert_array_equal(out[..., 0:3], 255 - img[..., 0:3])
    r2 = srv.request(port, {"input": str(src), "output": str(tmp_path / "o2.png"),
                            "script": str(script)})
    assert r2["ok"]
    ping = srv.request(port, {"cmd": "ping"})
    assert ping["ok"] and ping["jobs_done"] == 2 and ping["uptime_s"] >= 0
    assert (tmp_path / "o1.png").read_bytes() == (tmp_path / "o2.png").read_bytes()


def test_server_keep_going_on_bad_job(running_server, tmp_path):
    port = running_server
    bad = srv.request(port, {"input": str(tmp_path / "missing.png"),
                             "output": str(tmp_path / "x.png")})
    assert not bad["ok"] and "error" in bad
    src = _save(fixtures.solid(8, 8, (1, 2, 3, 255)), tmp_path / "ok.png")
    good = srv.request(port, {"input": str(src), "output": str(tmp_path / "y.png")})
    assert good["ok"]
    garbage = srv.request(port, {"cmd": "nonsense"})
    assert not garbage.get("shutdown")
    # a script error is a failed job with the error's type and message
    (tmp_path / "broken.rhai").write_text("apply_blur(;")
    err = srv.request(port, {"input": str(src), "output": str(tmp_path / "z.png"),
                             "script": str(tmp_path / "broken.rhai")})
    assert not err["ok"] and err["error"].startswith("ScriptError: ")
    assert garbage["error"].startswith("KeyError: ")  # a job with no input
    assert srv.request(port, {"cmd": "ping"})["jobs_done"] == 1  # successes only


def test_server_shutdown():
    s, port, t = _start(srv, device="cpu")
    r = srv.request(port, {"cmd": "shutdown"})
    assert r["ok"] and r["shutdown"]
    t.join(timeout=10)
    assert not t.is_alive()
    s.server_close()


def test_prefetch_images_order_and_errors(tmp_path):
    from paintfe_tpu_torch.parallel.prefetch import prefetch_images

    paths = []
    for i in range(6):
        p = tmp_path / f"f{i}.png"
        codecs.save_image(fixtures.solid(4, 4, (i * 10, 0, 0, 255)), p, "png")
        paths.append(p)
    paths.insert(3, tmp_path / "missing.png")
    results = list(prefetch_images(paths, load=lambda p: codecs.load_image(p, device="cpu"),
                                   depth=2, workers=2))
    assert [p for p, _ in results] == paths
    for i, (p, img) in enumerate(results):
        if i == 3:
            assert isinstance(img, Exception)
        else:
            assert isinstance(img, np.ndarray) and img.shape == (4, 4, 4)
            assert img[0, 0, 0] == (i if i < 3 else i - 1) * 10


def test_double_buffer_runs_in_order():
    from paintfe_tpu.parallel.prefetch import DoubleBuffer as JDoubleBuffer
    from paintfe_tpu_torch.parallel.prefetch import DoubleBuffer

    out = list(DoubleBuffer(lambda i: i * i, 5))
    assert out == [0, 1, 4, 9, 16] == list(JDoubleBuffer(lambda i: i * i, 5))


# --- the same jobs through both packages' servers -------------------------------


def _layered_docs(rng, h, w):
    """One three-layer document in both packages: background, MULTIPLY at
    0.7, SCREEN (the active layer), an empty block in every layer."""
    from paintfe_tpu_torch.core.blend import BlendMode
    from paintfe_tpu_torch.core.canvas import Canvas, Layer

    layers = []
    for k in range(3):
        px = rng.integers(0, 256, (h, w, 4), np.uint8)
        px[: h // 3, : w // 2] = 0
        if k == 0:
            px[..., 3] = 255
        layers.append(px)
    modes = [(0, 1.0), (1, 0.7), (2, 1.0)]
    jdoc, doc = JCanvas(width=w, height=h), Canvas(width=w, height=h)
    for k, (px, (mode, opacity)) in enumerate(zip(layers, modes)):
        jl, tl = JLayer(name=f"l{k}", pixels=px.copy()), Layer(name=f"l{k}", pixels=px.copy())
        jl.blend_mode, jl.opacity = JBlendMode(mode), opacity
        tl.blend_mode, tl.opacity = BlendMode(mode), opacity
        jdoc.layers.append(jl)
        doc.layers.append(tl)
    jdoc.active_layer_index = doc.active_layer_index = 2
    return jdoc, doc


@pytest.fixture
def job_files(tmp_path):
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (48, 64, 4), np.uint8)
    img[:6, :, 3] = 0
    Image.fromarray(img, "RGBA").save(tmp_path / "in.png")
    jdoc, doc = _layered_docs(rng, 48, 64)
    jpfe.save_pfe(jdoc, str(tmp_path / "jdoc.pfe"))
    from paintfe_tpu_torch.io import pfe

    pfe.save_pfe(doc, str(tmp_path / "doc.pfe"))
    assert (tmp_path / "jdoc.pfe").read_bytes() == (tmp_path / "doc.pfe").read_bytes()
    for name, text in (("headline", HEADLINE), ("spatial", SPATIAL), ("layered", LAYERED)):
        (tmp_path / f"{name}.rhai").write_text(text)
    return tmp_path


JOBS = {  # kind -> (input, script, format, output name)
    "headline": ("in.png", "headline", "png", "headline.png"),
    "spatial": ("in.png", "spatial", "png", "spatial.png"),
    "layered png": ("doc.pfe", "layered", "png", "layered.png"),
    "layered pfe": ("doc.pfe", "layered", "pfe", "layered.pfe"),
}


def _job(root, kind, out_dir):
    inp, script, fmt, name = JOBS[kind]
    return {"input": str(root / inp), "script": str(root / f"{script}.rhai"),
            "format": fmt, "output": str(root / out_dir / name)}


def test_same_jobs_same_bytes_as_jax_server(job_files):
    root = job_files
    servers = [(_start(jsrv), "jax"), (_start(srv, device="cpu"), "port")]
    try:
        for (s, port, _), tag in servers:
            module = jsrv if tag == "jax" else srv
            for kind in JOBS:
                reply = module.request(port, _job(root, kind, tag))
                assert reply["ok"], (tag, kind, reply)
            assert module.request(port, {"cmd": "ping"})["jobs_done"] == len(JOBS)
    finally:
        for (s, _, _), _ in servers:
            s.shutdown()
            s.server_close()
    for kind, (_, _, _, name) in JOBS.items():
        assert (root / "port" / name).read_bytes() == (root / "jax" / name).read_bytes(), kind


def test_job_defaults_and_output_dir(job_files, running_server):
    """No "output": the CLI's build_output_path under "output_dir" with the
    format's extension; the JAX job fields' defaults (png, quality 90,
    flatten)."""
    root = job_files
    port = running_server
    r = srv.request(port, {"input": str(root / "in.png"), "output_dir": str(root / "od"),
                           "format": "jpeg", "quality": 70})
    assert r["ok"] and r["output"] == str(root / "od" / "in.jpg")
    r = srv.request(port, {"input": str(root / "doc.pfe"), "output_dir": str(root / "od"),
                           "flatten": False})
    assert r["ok"] and r["output"] == str(root / "od" / "doc.png")
    from paintfe_tpu_torch.io import pfe

    doc = pfe.load_pfe(str(root / "doc.pfe"))
    np.testing.assert_array_equal(np.asarray(Image.open(root / "od" / "doc.png")),
                                  doc.layers[2].pixels)


def test_two_concurrent_clients_give_serial_bytes(job_files):
    """Two clients, each on its own connection, each sending the headline,
    spatial and layered jobs twice at once: every output equals the one
    the same job wrote alone, and ping counts every job."""
    root = job_files
    s, port, _ = _start(srv, device="cpu")
    kinds = ("headline", "spatial", "layered png")
    try:
        for kind in kinds:
            assert srv.request(port, _job(root, kind, "serial"))["ok"]

        def client(k, replies):
            with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
                f = sock.makefile("rwb")
                for rep in range(2):
                    for kind in kinds:
                        f.write((json.dumps(_job(root, kind, f"c{k}_{rep}")) + "\n").encode())
                        f.flush()
                        replies.append(json.loads(f.readline()))

        replies = [[], []]
        threads = [threading.Thread(target=client, args=(k, replies[k])) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert all(r["ok"] for rs in replies for r in rs) and sum(map(len, replies)) == 12
        assert srv.request(port, {"cmd": "ping"})["jobs_done"] == 3 + 12
    finally:
        s.shutdown()
        s.server_close()
    for k in range(2):
        for rep in range(2):
            for kind in kinds:
                name = JOBS[kind][3]
                assert (root / f"c{k}_{rep}" / name).read_bytes() == \
                    (root / "serial" / name).read_bytes(), (k, rep, kind)


def test_bad_json_line_then_next_job(job_files, running_server):
    root = job_files
    with socket.create_connection(("127.0.0.1", running_server), timeout=60) as sock:
        f = sock.makefile("rwb")
        f.write(b"{not json\n\n")
        f.flush()
        reply = json.loads(f.readline())
        assert not reply["ok"] and reply["error"].startswith("bad json: ")
        f.write((json.dumps(_job(root, "layered pfe", "after")) + "\n").encode())
        f.flush()
        assert json.loads(f.readline())["ok"]


def test_script_cache_evicts_on_mtime_and_stays_warm(tmp_path):
    import os

    cache = srv._ScriptCache(max_entries=3)
    a, b = tmp_path / "a.rhai", tmp_path / "b.rhai"
    a.write_text("apply_invert();")
    b.write_text("apply_blur(1.0);")
    assert cache.get(str(a)) == "apply_invert();"
    assert cache.get(str(b)) == "apply_blur(1.0);"
    # both paths stay warm: a hit does not read the file again
    a_key = next(k for k in cache._cache if k[0] == str(a))
    cache._cache[a_key] = "cached"
    assert cache.get(str(a)) == "cached" and len(cache._cache) == 2
    a.write_text("apply_sepia(0.5);")
    st = a.stat()
    os.utime(a, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert cache.get(str(a)) == "apply_sepia(0.5);"
    assert sorted(k[0] for k in cache._cache) == sorted([str(a), str(b)])  # stale a evicted
    c, d = tmp_path / "c.rhai", tmp_path / "d.rhai"
    c.write_text("c")
    d.write_text("d")
    cache.get(str(c))
    cache.get(str(d))  # over max_entries: the oldest entry (b) goes
    assert sorted(k[0] for k in cache._cache) == sorted([str(a), str(c), str(d)])
    with pytest.raises(FileNotFoundError):
        cache.get(str(tmp_path / "missing.rhai"))
    # the JAX package's cache keeps and evicts the same keys
    port_cache, jax_cache = srv._ScriptCache(max_entries=3), jsrv._ScriptCache(max_entries=3)
    for cache in (port_cache, jax_cache):
        for path in (a, b, c, d, a):
            cache.get(str(path))
    assert list(port_cache._cache) == list(jax_cache._cache)
    assert [k[0] for k in port_cache._cache] == [str(c), str(d), str(a)]


def test_script_cache_concurrent_gets(tmp_path):
    """Threads reading two alternating scripts while one is rewritten: every
    get returns one of the file's texts, none raises (the JAX docstring's
    KeyError under an unlocked clear)."""
    import os

    cache = srv._ScriptCache(max_entries=2)
    paths = [tmp_path / "x.rhai", tmp_path / "y.rhai"]
    for p in paths:
        p.write_text("apply_invert();")
    errors, texts = [], set()

    def reader():
        try:
            for i in range(300):
                texts.add(cache.get(str(paths[i % 2])))
        except Exception as e:  # recorded for the assertion below
            errors.append(e)

    def writer():  # whole files, as an editor saves them
        for i in range(50):
            tmp = tmp_path / "x.tmp"
            tmp.write_text(f"apply_blur({i}.0);")
            st = tmp.stat()
            os.utime(tmp, ns=(st.st_atime_ns, st.st_mtime_ns + i + 1))
            os.replace(tmp, paths[0])

    threads = [threading.Thread(target=reader) for _ in range(6)] + [threading.Thread(target=writer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert all(t == "apply_invert();" or t.startswith("apply_blur(") for t in texts)


def test_server_defaults_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.PaintServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.serve_tcp(port=0)


def test_main_device_cuda_without_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert srv.main(["--device", "cuda", "--port", "0"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert srv.main(["--port", "0"]) == 1  # cuda is the default


def _at_once(fn, n):
    """fn() on n threads released together; each thread's result or error."""
    barrier, out = threading.Barrier(n), [None] * n

    def run(k):
        barrier.wait()
        try:
            out[k] = fn()
        except Exception as e:  # the caller asserts on it
            out[k] = e

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_native_library_builds_once_for_concurrent_first_jobs(tmp_path, monkeypatch):
    """Handler threads whose first jobs need the host C++ at once: one g++
    run, every thread gets a working library (the temporary file is named
    by the process, so two builds at once would share it)."""
    import subprocess

    from paintfe_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    runs, real = [], subprocess.run

    def counting(cmd, **kw):
        runs.append(cmd)
        return real(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", counting)
    libs = _at_once(native.load.__wrapped__, 4)
    assert len(runs) == 1
    assert all(lib.png_defilter is not None for lib in libs), libs


def test_kernel_library_builds_one_at_a_time(tmp_path, monkeypatch):
    """The CUDA build is serialised the same way: nvcc's runs of two
    threads never overlap (its objects are named by the process)."""
    import time

    from paintfe_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "library_path", lambda: tmp_path / "libk.so")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    busy, peak = [0], [0]

    def fake_run_all(cmds):
        busy[0] += 1
        peak[0] = max(peak[0], busy[0])
        time.sleep(0.2)
        busy[0] -= 1
        return [(cmd, "", "no compiler here", 1, 0.2) for cmd in cmds]

    monkeypatch.setattr(cuda_build, "_run_all", fake_run_all)
    errors = _at_once(cuda_build.load_library.__wrapped__, 3)
    assert all(isinstance(e, RuntimeError) and "nvcc failed" in str(e) for e in errors)
    assert peak[0] == 1
