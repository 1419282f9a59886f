"""The port's transpiler tier (paintfe_tpu_torch.scripting.pycompile) under
the port's api, on the corpora of tests/test_pycompile.py: every script
runs tree-walked (PAINTFE_SCRIPT_COMPILE=0) and compiled (1, or auto for a
script with closures) in the port, and both must equal the JAX package's
tree-walked run (console, pixels, dims, error message) at tolerance 0.
The conformance corpus is imported from tests/test_rhai_conformance.py,
the rest from tests/test_pycompile.py."""

import time

import numpy as np
import pytest

import paintfe_tpu.scripting as jscript
import paintfe_tpu_torch.scripting as tscript
from paintfe_tpu.scripting import pycompile as jpyc
from paintfe_tpu_torch.scripting import interp as tinterp
from paintfe_tpu_torch.scripting import pycompile as tpyc

from test_pycompile import (CLOSURE_CASES, DIVERGENCE_PRONE, USER_FN_TREEWALK_CASES,
                            _has_closure)
from test_rhai_conformance import WORKING


def gradient_row():
    img = np.zeros((8, 8, 4), np.uint8)
    img[..., 0] = np.arange(8)[None, :] * 16
    img[..., 3] = 255
    return img


def run(pkg, src, mode, monkeypatch, img=None):
    """`src` through `pkg`'s engine with PAINTFE_SCRIPT_COMPILE=`mode` (the
    port on the CPU): ("ok", console, pixel bytes, w, h) or ("err", message)."""
    monkeypatch.setenv("PAINTFE_SCRIPT_COMPILE", mode)
    img = gradient_row() if img is None else img
    h, w = img.shape[:2]
    kw = {"device": "cpu"} if pkg is tscript else {}
    try:
        out, nw, nh, console, _ops = pkg.execute_script_sync(src, img.copy(), w, h, None, **kw)
        return ("ok", console, np.asarray(out).tobytes(), nw, nh)
    except pkg.ScriptError as e:
        return ("err", e.message)


def tiers(src, fast, monkeypatch, img=None):
    """The port's tree-walker against its `fast` tier, and both against
    the JAX package's tree-walker; returns the port's result."""
    walked = run(tscript, src, "0", monkeypatch, img)
    compiled = run(tscript, src, fast, monkeypatch, img)
    assert walked == compiled, f"engines diverge on:\n{src}\ninterp={walked}\ncompiled={compiled}"
    assert walked == run(jscript, src, "0", monkeypatch, img)
    return walked


@pytest.mark.parametrize("src,expected", WORKING)
def test_conformance_corpus_agrees(src, expected, monkeypatch):
    """A closure-free script compiles (mode 1); one with closures, which
    the transpiler refuses as a whole program, takes mode auto (closure
    bodies compiled, the script tree-walked)."""
    monkeypatch.setenv("PAINTFE_SCRIPT_COMPILE", "auto")
    compiles = tpyc.try_compile(src) is not None
    assert compiles == (jpyc.try_compile(src) is not None)
    res = tiers(src, "1" if compiles else "auto", monkeypatch)
    if res[0] == "ok":
        assert res[1] == expected


@pytest.mark.parametrize("src", DIVERGENCE_PRONE)
def test_divergence_prone_cases(src, monkeypatch):
    tiers(src, "1", monkeypatch)


def test_fast_path_actually_engages():
    assert tpyc.try_compile("let x = 1; print_line(`${x}`);") is not None
    assert tpyc.try_compile("let f = |a| a + 1; print_line(`${f.call(1)}`);") is None
    assert tpyc.try_compile("for_each_pixel(|r, g, b, a, x, y| [r, g, b, a]);") is None


def test_tier_attribution_corpus(monkeypatch):
    """Every closure-free WORKING + DIVERGENCE_PRONE script compiles in
    the port, each lands on the same tier as in the JAX package, and a
    fallback is only one of the bails the compiler makes by design."""
    monkeypatch.setenv("PAINTFE_SCRIPT_COMPILE", "auto")
    allowed_bails = {"closure", "fn inside closure", "is_def_var", "eval",
                     "loop value", "expression stmtexpr", "fn arity overload"}
    compiled = 0
    for src in [s for s, _ in WORKING] + DIVERGENCE_PRONE:
        ok = tpyc.try_compile(src) is not None
        assert ok == (jpyc.try_compile(src) is not None), src
        if ok:
            compiled += 1
            continue
        try:
            tpyc._compile_source(src)
            reason = "<compiled?>"
        except tpyc.TranspileUnsupported as e:
            reason = str(e)
        except Exception as e:  # pragma: no cover - regression guard
            reason = f"<{type(e).__name__}: {e}>"
        assert reason in allowed_bails or _has_closure(src), (
            f"closure-free script fell back to the tree-walker ({reason}):\n{src}")
    assert compiled >= 100
    for src in CLOSURE_CASES:
        assert _has_closure(src)


def test_operation_budget_enforced_compiled(monkeypatch):
    monkeypatch.setattr(tinterp, "MAX_OPERATIONS", 10_000)
    img = np.zeros((4, 4, 4), np.uint8)
    res = run(tscript, "loop { let x = 1; }", "1", monkeypatch, img)
    assert res[0] == "err" and "operation limit" in res[1]
    assert res == run(jscript, "loop { let x = 1; }", "1", monkeypatch, img)


def test_loop_throughput_improves(monkeypatch):
    """Compiled at least twice as fast as tree-walked in the port (the JAX
    test's margin), with the same console as the JAX package."""
    src = "let acc = 0; for i in 0..120000 { acc += i % 7; } print_line(`${acc}`);"
    img = np.zeros((4, 4, 4), np.uint8)

    def timed(mode):
        monkeypatch.setenv("PAINTFE_SCRIPT_COMPILE", mode)
        t0 = time.perf_counter()
        console = tscript.execute_script_sync(src, img, 4, 4, None, device="cpu")[3]
        return console, time.perf_counter() - t0

    a, walk = timed("0")
    b, comp = timed("1")
    assert a == b == run(jscript, src, "0", monkeypatch, img)[1]
    assert comp * 2 < walk, f"compiled {comp:.3f}s vs walked {walk:.3f}s"


@pytest.mark.parametrize("src", CLOSURE_CASES)
def test_closure_compiled_vs_interp(src, monkeypatch):
    tiers(src, "auto", monkeypatch)


def test_impure_per_pixel_loop_equivalent_and_faster(monkeypatch):
    src = ("let n = 0; for_region(0, 0, 32, 32, |x, y, r, g, b, a| "
           "{ n += 1; [g, b, r, a] }); print_line(`${n}`);")
    img = np.zeros((32, 32, 4), np.uint8)
    img[..., 0] = 90
    img[..., 3] = 255
    # warm both tiers first, as the JAX test does
    res = tiers(src, "auto", monkeypatch, img)
    assert res[1] == ["1024"]

    def best_of(env, k=3):
        monkeypatch.setenv("PAINTFE_SCRIPT_COMPILE", env)
        best = float("inf")
        for _ in range(k):
            t0 = time.perf_counter()
            tscript.execute_script_sync(src, img.copy(), 32, 32, None, device="cpu")
            best = min(best, time.perf_counter() - t0)
        return best

    walk = best_of("0")
    comp = best_of("auto")
    assert comp < walk, f"compiled {comp:.3f}s not faster than {walk:.3f}s"


@pytest.mark.parametrize("src", USER_FN_TREEWALK_CASES)
def test_user_fns_compiled_in_treewalk_context(src, monkeypatch):
    tiers(src, "auto", monkeypatch)


def test_midloop_throw_commits_nothing(monkeypatch):
    src = ('try { for_each_pixel(|x, y, r, g, b, a| '
           '{ if y == 2 { throw "stop"; } [9, 9, 9, 255] }); } '
           'catch (e) { print_line(e); }')
    img = np.zeros((4, 4, 4), np.uint8)
    img[..., 3] = 255
    res = tiers(src, "auto", monkeypatch, img)
    assert res[1] == ["stop"]
    assert res[2] == img.tobytes()


def test_switch_and_negation_inside_compiled_closure(monkeypatch):
    src = ("for_each_pixel(|x, y, r, g, b, a| {"
           " [switch r { 0..=100 => 30, _ => 220 }, -(-g), b, a] });"
           "print_line(`${get_r(0, 0)}`);")
    img = np.zeros((4, 4, 4), np.uint8)
    img[..., 0] = 150
    img[..., 3] = 255
    res = tiers(src, "auto", monkeypatch, img)
    assert res[1] == ["220"]
    assert (np.frombuffer(res[2], np.uint8).reshape(4, 4, 4)[..., 0] == 220).all()
