"""The port's pixel-loop tiers (paintfe_tpu_torch.scripting.api._bulk_apply:
the purity-scan vectorizer, the compiled region runner, the scalar loop)
on the generative fuzz of tests/test_pixel_loop_fuzz.py (its Gen and
image, all 200 seeds): forced-scalar tree-walk (closure_is_pure patched to
False in the port's api; the oracle), auto, and compile-disabled must
agree exactly in the port, and the port's oracle must equal the JAX
package's (pixels, console, error message)."""

import numpy as np
import pytest

import paintfe_tpu.scripting as jscript
import paintfe_tpu_torch.scripting as tscript
from paintfe_tpu.scripting import api as japi
from paintfe_tpu_torch.scripting import api as tapi

from test_pixel_loop_fuzz import Gen, _img


def run(pkg, src, mode, monkeypatch, force_scalar=False):
    api = tapi if pkg is tscript else japi
    kw = {"device": "cpu"} if pkg is tscript else {}
    with monkeypatch.context() as m:
        m.setenv("PAINTFE_SCRIPT_COMPILE", mode)
        if force_scalar:
            m.setattr(api, "closure_is_pure", lambda *a, **k: False)
        try:
            out, _w, _h, console, _ops = pkg.execute_script_sync(src, _img(), 4, 5, None, **kw)
            return ("ok", console, np.asarray(out).tobytes())
        except pkg.ScriptError as e:
            return ("err", e.message)
        except Exception as e:
            return ("raw", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(200))
def test_pixel_loop_fuzz_engines_agree(seed, monkeypatch):
    src = Gen(seed).program()
    oracle = run(tscript, src, "0", monkeypatch, force_scalar=True)
    auto = run(tscript, src, "auto", monkeypatch)
    v0 = run(tscript, src, "0", monkeypatch)
    assert oracle == auto == v0, (
        f"engines diverge (seed {seed}):\n{src}\noracle={oracle}\nauto={auto}\nv0={v0}")
    assert oracle == run(jscript, src, "0", monkeypatch, force_scalar=True), (
        f"port differs (seed {seed}):\n{src}")
