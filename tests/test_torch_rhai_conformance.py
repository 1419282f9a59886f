"""The port's script engine (paintfe_tpu_torch.scripting: engine, interp,
api) on the Rhai conformance corpus of tests/test_rhai_conformance.py:
each WORKING script gives the JAX package's console and the expected one,
each TARGETED_ERRORS script the JAX package's error (message, location,
friendly text), and the system errors stay uncatchable in both."""

import threading

import numpy as np
import pytest

import paintfe_tpu.scripting as jscript
import paintfe_tpu_torch.scripting as tscript
from paintfe_tpu.scripting import interp as jinterp
from paintfe_tpu_torch.scripting import interp as tinterp

from test_rhai_conformance import TARGETED_ERRORS, WORKING


def run(pkg, src):
    """`src` through `pkg`'s engine on an 8x8 clear image (the port on the
    CPU): ("ok", console, pixels) or ("err", message, line, column, text,
    friendly text)."""
    img = np.zeros((8, 8, 4), np.uint8)
    kw = {"device": "cpu"} if pkg is tscript else {}
    try:
        out, _w, _h, console, _ops = pkg.execute_script_sync(src, img, 8, 8, None, **kw)
    except pkg.ScriptError as e:
        return ("err", e.message, e.line, e.column, str(e), e.friendly_message())
    return ("ok", console, np.asarray(out).tobytes())


def both(src):
    out = run(tscript, src)
    assert out == run(jscript, src)
    return out


@pytest.mark.parametrize("src,expected", WORKING, ids=[s[:48] for s, _ in WORKING])
def test_feature_works(src, expected):
    out = both(src)
    assert out[:2] == ("ok", expected)


@pytest.mark.parametrize("src,needle", TARGETED_ERRORS, ids=[s[:40] for s, _ in TARGETED_ERRORS])
def test_targeted_error(src, needle):
    out = both(src)
    assert out[0] == "err"
    assert needle in out[4], out[4]


def test_unsupported_keyword_carries_location():
    out = both("let a = 1;\nimport \"m\" as m;")
    assert out[0] == "err"
    assert out[2:4] == (2, 1)


@pytest.mark.parametrize("src,max_ops,needle", [
    ("try { loop { let x = 1; } } catch (e) { }", 200, "operation limit"),
    ("fn f(n) { f(n + 1) } try { f(0); } catch (e) { }", None, "call depth"),
], ids=["operation_budget", "call_depth"])
def test_system_error_not_catchable(src, max_ops, needle):
    def message(interp):
        kw = {} if max_ops is None else {"max_operations": max_ops}
        with pytest.raises(interp.RhaiSystemError, match=needle) as ei:
            interp.Interpreter({}, **kw).run(src)
        return ei.value.message

    assert message(tinterp) == message(jinterp)


def test_cancellation_not_catchable():
    """A cancel mid-script terminates even inside try/catch, in both."""

    def last(engine, **kw):
        cancel = threading.Event()
        cancel.set()
        thread, messages = engine.execute_script_async(
            "try { loop { let x = 1; } } catch (e) { }", np.zeros((8, 8, 4), np.uint8),
            8, 8, cancel_event=cancel, **kw)
        thread.join(timeout=30)
        assert not thread.is_alive()
        msgs = []
        while not messages.empty():
            msgs.append(messages.get())
        return msgs[-1].kind, msgs[-1].payload.message

    got = last(tscript, device="cpu")
    assert got == last(jscript)
    assert got[0] == "error"
    assert "cancelled" in got[1].lower()


@pytest.mark.parametrize("src,needle", [
    ("frobnicate();", "Could not find function"),
    ("let x = y + 1;", "is not defined"),
    ('import "m" as m;', "unsupported Rhai feature"),
    ("let a = [1]; let x = a[5];", "index"),
])
def test_friendly_message_categories(src, needle):
    out = both(src)
    assert out[0] == "err"
    assert needle in out[5]


def test_friendly_message_operation_limit():
    msg = "script exceeded the operation limit (50000000)"
    friendly = tscript.ScriptError(msg).friendly_message()
    assert friendly == jscript.ScriptError(msg).friendly_message()
    assert "50 million" in friendly
