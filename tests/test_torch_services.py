"""The port's plugin host (paintfe_tpu_torch.ops.plugins) and AI background
remover (paintfe_tpu_torch.ops.ai) against the JAX package's: the plugin
and AI cases of tests/test_misc_subsystems.py and the eight of
tests/test_ai.py, each run on both packages with the same demo plugin and
the same fake ONNX session, outputs equal at tolerance 0
(device="cpu"); the smoke's numpy plugin and deterministic sessions at a
small size."""

import stat
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from paintfe_tpu.core import fixtures as jfixtures
from paintfe_tpu.ops import ai as jai
from paintfe_tpu.ops.plugins import PluginError as JPluginError
from paintfe_tpu.ops.plugins import PluginHost as JPluginHost
from paintfe_tpu_torch.core import fixtures
from paintfe_tpu_torch.ops import ai
from paintfe_tpu_torch.ops.plugins import PluginError, PluginHost, TrustList

PLUGIN_SRC = '''#!/usr/bin/env python3
import sys, json, base64
for line in sys.stdin:
    req = json.loads(line)
    if req["cmd"] == "describe":
        print(json.dumps({"name": "demo", "effects": [{"id": "invert", "name": "Invert"}]}), flush=True)
    elif req["cmd"] == "render":
        raw = bytearray(base64.b64decode(req["pixels_b64"]))
        for i in range(0, len(raw), 4):
            raw[i] = 255 - raw[i]
            raw[i+1] = 255 - raw[i+1]
            raw[i+2] = 255 - raw[i+2]
        print(json.dumps({"ok": True, "pixels_b64": base64.b64encode(bytes(raw)).decode()}), flush=True)
'''


def _write_plugin(tmp_path, src=PLUGIN_SRC, name="demo_plugin.py"):
    p = tmp_path / name
    p.write_text(src)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return p


# --- plugins --------------------------------------------------------------------


def test_plugin_host_describe_render(tmp_path):
    exe = _write_plugin(tmp_path)
    host, jhost = PluginHost(exe), JPluginHost(exe)
    try:
        desc = host.describe()
        assert desc == jhost.describe()
        assert desc["effects"][0]["id"] == "invert"
        img = fixtures.test_gradient(16, 16)
        out = host.render("invert", torch.from_numpy(img))
        assert out.dtype == torch.uint8 and out.device.type == "cpu"
        np.testing.assert_array_equal(out[..., 0].numpy(), 255 - img[..., 0])
        np.testing.assert_array_equal(out[..., 3].numpy(), img[..., 3])
        np.testing.assert_array_equal(
            out.numpy(), jhost.render("invert", jfixtures.test_gradient(16, 16)))
        # a numpy input is taken as a CPU tensor
        again = host.render("invert", img)
        assert isinstance(again, torch.Tensor) and torch.equal(again, out)
    finally:
        host.close()
        jhost.close()


def test_plugin_render_strided_tensor(tmp_path):
    """A strided view (a crop of a larger frame) is sent as its own pixels."""
    exe = _write_plugin(tmp_path)
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, (30, 40, 4), np.uint8)
    view = torch.from_numpy(big)[5:25, 7:31]
    host = PluginHost(exe)
    try:
        out = host.render("invert", view, {"unused": 1})
    finally:
        host.close()
    want = big[5:25, 7:31].copy()
    want[..., :3] = 255 - want[..., :3]
    np.testing.assert_array_equal(out.numpy(), want)


def test_plugin_trust_list(tmp_path):
    exe = _write_plugin(tmp_path)
    trust = TrustList(tmp_path / "trust.txt")
    with pytest.raises(PluginError):
        PluginHost(exe, trust=trust)
    trust.trust(exe)
    host = PluginHost(exe, trust=TrustList(tmp_path / "trust.txt"))
    host.close()
    # the JAX package reads the same trust file
    from paintfe_tpu.ops.plugins import TrustList as JTrustList

    assert JTrustList(tmp_path / "trust.txt").hashes == trust.hashes
    assert TrustList.digest(exe) == JTrustList.digest(exe)


def test_plugin_trust_covers_file_arguments(tmp_path):
    """An argument that is an existing file (the DLL a .NET host runs) must
    be trusted too; the launcher prefixes the command line."""
    exe = _write_plugin(tmp_path)
    dll = tmp_path / "effect.dll"
    dll.write_bytes(b"MZ not really")
    trust = TrustList(tmp_path / "trust.txt")
    trust.trust(exe)
    with pytest.raises(PluginError, match="effect.dll"):
        PluginHost(exe, trust=trust, args=(str(dll),))
    with pytest.raises(JPluginError, match="effect.dll"):
        JPluginHost(exe, trust=trust, args=(str(dll),))
    trust.trust(dll)
    host = PluginHost(exe, trust=trust, args=(str(dll), "--flag"),
                      launcher=(sys.executable,))
    try:
        assert host.describe()["name"] == "demo"
        assert host.proc.args == [sys.executable, str(exe), str(dll), "--flag"]
    finally:
        host.close()
    with pytest.raises(PluginError, match="not found"):
        PluginHost(tmp_path / "missing.py")


def test_plugin_crash_and_bad_reply(tmp_path):
    crash = _write_plugin(tmp_path, "#!/usr/bin/env python3\nimport sys\nsys.exit(3)\n",
                          "crash.py")
    host = PluginHost(crash)
    with pytest.raises(PluginError):
        host.describe()
    host.close()
    bad = _write_plugin(tmp_path, "#!/usr/bin/env python3\nimport sys\nsys.stdin.readline()\n"
                        "print('not json', flush=True)\n", "bad.py")
    host = PluginHost(bad)
    with pytest.raises(PluginError, match="bad plugin response"):
        host.describe()
    host.close()
    refuse = _write_plugin(tmp_path, "#!/usr/bin/env python3\nimport sys, json\n"
                           "sys.stdin.readline()\n"
                           "print(json.dumps({'ok': False, 'error': 'nope'}), flush=True)\n",
                           "refuse.py")
    host = PluginHost(refuse)
    with pytest.raises(PluginError, match="render failed: nope"):
        host.render("invert", np.zeros((2, 2, 4), np.uint8))
    host.close()


def test_plugin_unresponsive_times_out(tmp_path):
    p = _write_plugin(tmp_path, "#!/usr/bin/env python3\nimport time\ntime.sleep(600)\n",
                      "hang_plugin.py")
    host = PluginHost(p, timeout=1.0)
    t0 = time.monotonic()
    with pytest.raises(PluginError, match="unresponsive"):
        host.describe()
    assert time.monotonic() - t0 < 10.0
    host.close()
    assert host.proc is None


def test_smoke_numpy_plugin(tmp_path):
    """chip_smoke's demo plugin (numpy invert, alpha kept) at 64x48 gives
    the bytes of the JAX tests' demo plugin (a Python loop)."""
    exe = _write_plugin(tmp_path, chip_smoke.NUMPY_PLUGIN, "np_plugin.py")
    slow = _write_plugin(tmp_path)
    img = np.random.default_rng(9).integers(0, 256, (48, 64, 4), np.uint8)
    hosts = [PluginHost(exe, launcher=(sys.executable,)), PluginHost(slow)]
    try:
        fast, ref = (h.render("invert", torch.from_numpy(img)) for h in hosts)
    finally:
        for h in hosts:
            h.close()
    assert torch.equal(fast, ref)
    assert torch.equal(fast, chip_smoke.inverted(torch.from_numpy(img)))


# --- AI ---------------------------------------------------------------------------


class FakeInput:
    name = "input_image"


class FakeSession:
    """Session double: records the feed, returns a canned output."""

    def __init__(self, output_fn):
        self.output_fn = output_fn
        self.last_feed = None
        self.calls = 0

    def get_inputs(self):
        return [FakeInput()]

    def run(self, _outs, feeds):
        self.last_feed = feeds
        self.calls += 1
        return [self.output_fn(feeds["input_image"])]


def _img(h=20, w=30):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    img[..., 3] = 255
    return img


def _both(kind="u2net", out_fn=lambda x: None):
    """The port's and the JAX package's remover on one fake session."""
    sess = FakeSession(out_fn)
    return (ai.BackgroundRemover(model_kind=kind, session=sess, device="cpu"),
            jai.BackgroundRemover(model_kind=kind, session=sess), sess)


def test_preprocess_layout_and_normalization():
    br, jbr, _ = _both("u2net", lambda x: np.zeros((1, 1, 8, 8), np.float32))
    assert br.size == 320
    img = np.zeros((10, 10, 4), np.uint8)
    img[..., 0] = 255
    img[..., 3] = 255
    x = br.preprocess(torch.from_numpy(img))
    assert x.shape == (1, 3, 320, 320) and x.dtype == torch.float32
    assert np.allclose(x[0, 0].numpy(), (1.0 - 0.485) / 0.229, atol=1e-5)
    assert np.allclose(x[0, 1].numpy(), (0.0 - 0.456) / 0.224, atol=1e-5)
    assert np.allclose(x[0, 2].numpy(), (0.0 - 0.406) / 0.225, atol=1e-5)
    np.testing.assert_array_equal(x.numpy(), jbr.preprocess(img))


@pytest.mark.parametrize("kind", ["u2net", "birefnet"])
def test_preprocess_equals_jax(kind):
    """Noise at an odd size, both model sizes: the JAX array, bit for bit."""
    br, jbr, _ = _both(kind)
    img = np.random.default_rng(4).integers(0, 256, (37, 61, 4), np.uint8)
    x = br.preprocess(img)
    want = jbr.preprocess(img)
    assert x.shape == want.shape and x.is_contiguous()
    np.testing.assert_array_equal(x.numpy().view(np.uint32), want.view(np.uint32))


def test_model_kind_sets_input_size():
    sess = FakeSession(lambda x: np.zeros((1, 1, 4, 4), np.float32))
    for kind, size in (("birefnet", 1024), ("u2net", 320), ("isnet", 1024),
                       ("unknown", 320)):
        br = ai.BackgroundRemover(model_kind=kind, session=sess, device="cpu")
        assert br.size == size == jai.BackgroundRemover(model_kind=kind, session=sess).size
    assert ai._MODEL_INPUT_SIZES == jai._MODEL_INPUT_SIZES


def test_postprocess_sigmoid_applied_to_logits():
    br, jbr, _ = _both()
    logits = np.array([[[[-20.0, 0.0], [0.0, 20.0]]]], np.float32)
    mask = br.postprocess(logits, 2, 2)
    assert mask.shape == (2, 2)
    assert mask[0, 0] < 0.01 and mask[1, 1] > 0.99
    np.testing.assert_array_equal(mask.numpy(), jbr.postprocess(logits, 2, 2))


def test_postprocess_passthrough_for_probabilities():
    br, jbr, _ = _both()
    probs = np.array([[[[0.25, 0.75], [0.25, 0.75]]]], np.float32)
    mask = br.postprocess(probs, 2, 2)
    assert mask[0, 0] == 0.0 and mask[0, 1] == 1.0
    np.testing.assert_array_equal(mask.numpy(), jbr.postprocess(probs, 2, 2))


def test_postprocess_constant_mask_no_divide_by_zero():
    br, jbr, _ = _both()
    out = np.full((1, 1, 4, 4), 0.5, np.float32)
    mask = br.postprocess(out, 8, 8)
    assert bool((mask == mask[0, 0]).all())
    assert abs(float(mask[0, 0]) - 0.5) <= 1.0 / 255.0
    np.testing.assert_array_equal(mask.numpy(), jbr.postprocess(out, 8, 8))


@pytest.mark.parametrize("probabilities", [False, True])
@pytest.mark.parametrize("size", [(33, 47), (320, 512)])
def test_postprocess_equals_jax(probabilities, size):
    """Continuous logits and probabilities, scaled up and down."""
    rng = np.random.default_rng(11)
    raw = rng.standard_normal((1, 1, 320, 320)).astype(np.float32) * np.float32(3.0)
    if probabilities:
        raw = np.clip(raw * np.float32(0.1) + np.float32(0.5), 0, 1)
    br, jbr, _ = _both()
    got = br.postprocess(raw, *size)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  jbr.postprocess(raw, *size).view(np.uint32))


def test_remove_background_multiplies_alpha():
    def out_fn(x):
        m = np.zeros((1, 1, 320, 320), np.float32)
        m[..., :160] = 1.0
        return m

    br, jbr, sess = _both("u2net", out_fn)
    img = _img(16, 32)
    out = br.remove_background(torch.from_numpy(img))
    assert out.shape == img.shape and out.dtype == torch.uint8
    assert np.array_equal(out[..., :3].numpy(), img[..., :3])
    assert (out[:, :4, 3] == 255).all()
    assert (out[:, -4:, 3] == 0).all()
    assert sess.last_feed["input_image"].shape == (1, 3, 320, 320)
    assert isinstance(sess.last_feed["input_image"], np.ndarray)
    np.testing.assert_array_equal(out.numpy(), jbr.remove_background(img))


def test_remove_background_threshold_binarizes():
    def out_fn(x):
        return np.linspace(0, 1, 320 * 320, dtype=np.float32).reshape(1, 1, 320, 320)

    br, jbr, _ = _both("u2net", out_fn)
    img = _img(10, 10)
    out = br.remove_background(img, threshold=0.5)
    assert set(np.unique(out[..., 3].numpy())).issubset({0, 255})
    np.testing.assert_array_equal(out.numpy(), jbr.remove_background(img, threshold=0.5))


@pytest.mark.parametrize("kind", ["u2net", "birefnet"])
@pytest.mark.parametrize("probabilities", [False, True])
@pytest.mark.parametrize("threshold", [None, 0.3])
def test_smoke_session_equals_jax(kind, probabilities, threshold):
    """chip_smoke's deterministic session (logits, or probabilities) at
    64x48 with translucent alpha: the port's remover on the CPU equals the
    JAX package's, the session is run once a call on one numpy array."""
    img = np.random.default_rng(13).integers(0, 256, (48, 64, 4), np.uint8)
    sess = chip_smoke.SmokeSession(probabilities)
    br = ai.BackgroundRemover(model_kind=kind, session=sess, device="cpu")
    jbr = jai.BackgroundRemover(model_kind=kind, session=chip_smoke.SmokeSession(probabilities))
    out = br.remove_background(torch.from_numpy(img), threshold)
    np.testing.assert_array_equal(out.numpy(), jbr.remove_background(img, threshold))
    assert sess.calls == 1
    raw = sess.run(None, {"input": br.preprocess(img).numpy()})[0]
    assert (raw.min() < 0 or raw.max() > 1) != probabilities


def test_missing_onnxruntime_is_gated(monkeypatch):
    import importlib.util

    if importlib.util.find_spec("onnxruntime") is not None:
        pytest.skip("onnxruntime installed here")
    assert not ai.available() and not jai.available()
    with pytest.raises(ai.AiUnavailable, match="onnxruntime"):
        ai.BackgroundRemover(model_path="/nonexistent.onnx", device="cpu")
    with pytest.raises(ai.AiUnavailable) as te:
        ai.BackgroundRemover("/nonexistent.onnx", device="cpu")
    with pytest.raises(jai.AiUnavailable) as je:
        jai.BackgroundRemover("/nonexistent.onnx")
    assert str(te.value) == str(je.value)


def test_remover_defaults_to_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ai.BackgroundRemover(session=FakeSession(lambda x: None))
