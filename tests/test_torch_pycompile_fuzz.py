"""The port's two script tiers on the generative fuzz of
tests/test_pycompile_fuzz.py (its Gen, all 320 seeds): each random
closure-free program runs tree-walked (PAINTFE_SCRIPT_COMPILE=0) and
transpiled (1) in the port, the two must agree exactly, and the port's
tree-walked result (the oracle) must equal the JAX package's: console,
pixels and error message, or the same escaping exception."""

import numpy as np
import pytest

import paintfe_tpu.scripting as jscript
import paintfe_tpu_torch.scripting as tscript

from test_pycompile_fuzz import Gen


def run(pkg, src, mode, monkeypatch):
    monkeypatch.setenv("PAINTFE_SCRIPT_COMPILE", mode)
    kw = {"device": "cpu"} if pkg is tscript else {}
    try:
        out, _w, _h, console, _ops = pkg.execute_script_sync(
            src, np.zeros((4, 4, 4), np.uint8), 4, 4, None, **kw)
        return ("ok", console, np.asarray(out).tobytes())
    except pkg.ScriptError as e:
        return ("err", e.message)
    except Exception as e:  # raw escapes must at least match by type and text
        return ("raw", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(320))
def test_fuzz_engines_agree(seed, monkeypatch):
    src = Gen(seed).program()
    walked = run(tscript, src, "0", monkeypatch)
    compiled = run(tscript, src, "1", monkeypatch)
    assert walked == compiled, f"engines diverge (seed {seed}):\n{src}\n{walked}\nvs\n{compiled}"
    assert walked == run(jscript, src, "0", monkeypatch), f"port differs (seed {seed}):\n{src}"
