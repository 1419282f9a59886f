"""The port on the property and fuzz cases of tests/test_robustness.py:
.pfe round trips, truncated and garbage Paint.NET streams (io.nrbf,
io.pdn), the script engine's operation and call-depth limits, the deep
TIFF reader on garbage, and the blend property over all 25 modes
(core.blend.blend_u8 on CPU tensors, no jit).  Files the port writes
equal the JAX package's byte for byte; readers give the JAX package's
result or the same error.  The truncated-stream case reads a .pdn written
by chip_smoke.pdn_bytes in the layout of the reference's
layers-opacity-additive.pdn, so it needs no reference checkout."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from paintfe_tpu.core import blend as jblend
from paintfe_tpu.io import nrbf as jnrbf
from paintfe_tpu.io import pdn as jpdn
from paintfe_tpu.io import pfe as jpfe
from paintfe_tpu_torch.core import blend as tblend
from paintfe_tpu_torch.io import nrbf as tnrbf
from paintfe_tpu_torch.io import pdn as tpdn
from paintfe_tpu_torch.io import pfe as tpfe

from test_robustness import _nrbf_prim_string


def test_pfe_roundtrip_fuzz(tmp_path):
    from paintfe_tpu.core.canvas import Canvas as JCanvas, Layer as JLayer
    from paintfe_tpu_torch.core.canvas import Canvas, Layer

    rng = np.random.default_rng(11)
    for trial in range(5):
        w, h = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        specs = [(rng.integers(0, 256, (h, w, 4), np.uint8), float(rng.random()),
                  int(rng.integers(0, 25)), bool(rng.integers(0, 2)))
                 for _ in range(int(rng.integers(1, 5)))]

        def build(canvas_cls, layer_cls, mode_cls):
            c = canvas_cls.new(w, h)
            c.layers = []
            for i, (px, opacity, mode, visible) in enumerate(specs):
                layer = layer_cls.new(f"L{i}", w, h)
                layer.pixels, layer.opacity = px, opacity
                layer.blend_mode, layer.visible = mode_cls(mode), visible
                c.layers.append(layer)
            return c

        c = build(Canvas, Layer, tblend.BlendMode)
        path = tmp_path / f"fuzz_{trial}.pfe"
        tpfe.save_pfe(c, str(path))
        jpfe.save_pfe(build(JCanvas, JLayer, jblend.BlendMode), str(tmp_path / "j.pfe"))
        assert path.read_bytes() == (tmp_path / "j.pfe").read_bytes()
        back, jback = tpfe.load_pfe(str(path)), jpfe.load_pfe(str(path))
        assert (back.width, back.height) == (jback.width, jback.height) == (w, h)
        assert len(back.layers) == len(jback.layers) == len(specs)
        for a, b, j in zip(c.layers, back.layers, jback.layers):
            np.testing.assert_array_equal(b.pixels, np.asarray(j.pixels))
            np.testing.assert_array_equal(np.asarray(a.pixels), np.asarray(b.pixels))
            assert (int(b.blend_mode), b.visible, b.opacity) == (int(j.blend_mode), j.visible,
                                                                 j.opacity)
            assert a.blend_mode == b.blend_mode and a.visible == b.visible
            assert abs(a.opacity - b.opacity) < 1e-6


def additive_pdn():
    """A 2-layer document: a red Normal background under a green Additive
    layer at opacity 161."""
    h, w = 60, 80
    layers = []
    for name, rgb, opacity, blend in (("Background", (255, 0, 0), 255, "Normal"),
                                      ("Layer 2", (0, 255, 0), 161, "Additive")):
        px = np.zeros((h, w, 4), np.uint8)
        px[...] = rgb + (255,)
        layers.append(dict(name=name, pixels=px, visible=True, opacity=opacity, blend=blend))
    return chip_smoke.pdn_bytes(layers, w, h)


def test_nrbf_truncated_streams_error_cleanly():
    good = additive_pdn()
    hlen = good[4] | (good[5] << 8) | (good[6] << 16)
    body_off = 7 + hlen + 2
    full = tnrbf.NrbfReader(good, body_off).parse()
    assert full.end_pos is not None
    assert full.end_pos == jnrbf.NrbfReader(good, body_off).parse().end_pos
    # every truncation point raises in both readers, never hangs or crashes
    for cut in (body_off + 3, body_off + 50, full.end_pos - 10):
        with pytest.raises((tnrbf.NrbfError, ValueError, IndexError)) as ei:
            tnrbf.NrbfReader(good[:cut], body_off).parse()
        with pytest.raises((jnrbf.NrbfError, ValueError, IndexError)) as ej:
            jnrbf.NrbfReader(good[:cut], body_off).parse()
        assert (type(ei.value).__name__, str(ei.value)) == (type(ej.value).__name__,
                                                            str(ej.value))


def test_pdn_garbage_bodies_rejected(tmp_path):
    rng = np.random.default_rng(3)
    for trial in range(3):
        p = tmp_path / f"junk{trial}.pdn"
        p.write_bytes(b"PDN3" + bytes([8, 0, 0]) + b"<a></a>\x00" + rng.bytes(200))
        with pytest.raises(tpdn.PdnError):
            tpdn.load_pdn(p)
        with pytest.raises(jpdn.PdnError):
            jpdn.load_pdn(p)


def test_script_operation_budget_enforced():
    from paintfe_tpu.scripting import api as japi, interp as jinterp
    from paintfe_tpu_torch.scripting import api as tapi, interp as tinterp

    def message(api, interp, **kw):
        ctx = api.ScriptContext(np.zeros((4, 4, 4), np.uint8), 4, 4, None, rng_seed=0, **kw)
        ref = {}
        it = interp.Interpreter(api.build_host_fns(ctx, ref), max_operations=10_000)
        ref["interp"] = it
        with pytest.raises(interp.RhaiRuntimeError, match="operation limit") as ei:
            it.run("let i = 0; while true { i += 1; }")
        return ei.value.message

    assert message(tapi, tinterp, device="cpu") == message(japi, jinterp)


def test_script_recursion_depth_limited():
    import paintfe_tpu.scripting as jscript
    import paintfe_tpu_torch.scripting as tscript

    img = np.zeros((4, 4, 4), np.uint8)
    with pytest.raises(tscript.ScriptError) as ei:
        tscript.execute_script_sync("fn f(n) { f(n + 1) } f(0);", img, 4, 4, device="cpu")
    with pytest.raises(jscript.ScriptError) as ej:
        jscript.execute_script_sync("fn f(n) { f(n + 1) } f(0);", img, 4, 4)
    assert ei.value.message == ej.value.message


def test_deep_export_tiff_reader_rejects_garbage(tmp_path):
    from paintfe_tpu.io.deep_export import read_tiff_deep as jread
    from paintfe_tpu_torch.io.deep_export import read_tiff_deep

    p = tmp_path / "junk.tiff"
    p.write_bytes(b"definitely not a tiff")
    with pytest.raises(ValueError) as ei:
        read_tiff_deep(p)
    with pytest.raises(ValueError) as ej:
        jread(p)
    assert str(ei.value) == str(ej.value)


def pair(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (16, 16, 4), np.uint8),
            rng.integers(0, 256, (16, 16, 4), np.uint8))


@pytest.mark.parametrize("mode", range(25))
def test_blend_u8_transparent_top_is_identity(mode):
    """A fully transparent top leaves the base as it is, in every mode."""
    base, top = pair(4)
    clear = top.copy()
    clear[..., 3] = 0
    out = tblend.blend_u8(torch.from_numpy(base), torch.from_numpy(clear), mode, 1.0).numpy()
    ref = np.asarray(jax.jit(lambda b, t: jblend.blend_u8(b, t, mode, 1.0))(base, clear))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, base, err_msg=f"mode {mode}")


def test_blend_u8_opaque_normal_is_top():
    base, top = pair(4)
    opaque = top.copy()
    opaque[..., 3] = 255
    out = tblend.blend_u8(torch.from_numpy(base), torch.from_numpy(opaque), 0, 1.0).numpy()
    ref = np.asarray(jax.jit(lambda b, t: jblend.blend_u8(b, t, 0, 1.0))(base, opaque))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, opaque)


def _lp(s):
    b = s.encode()
    return bytes([len(b)]) + b


def both_parse(stream):
    """`stream` through both NRBF readers; the port's reader and the JAX
    package's."""
    return tnrbf.NrbfReader(stream, 0).parse(), jnrbf.NrbfReader(stream, 0).parse()


def test_nrbf_binarylibrary_in_member_slot():
    import struct

    stream = (
        b"\x00" + struct.pack("<iiii", 1, -1, 1, 0)
        + b"\x0c" + struct.pack("<i", 1) + _lp("Lib1")
        + b"\x05" + struct.pack("<i", 1) + _lp("C") + struct.pack("<i", 1)
        + _lp("a") + b"\x02" + struct.pack("<i", 1)
        # member slot: BinaryLibrary(id=2) then the actual value (a string)
        + b"\x0c" + struct.pack("<i", 2) + _lp("Lib2")
        + _nrbf_prim_string(7, "hello")
        + b"\x0b")
    reader, jreader = both_parse(stream)
    objs, jobjs = reader.find_instances("C"), jreader.find_instances("C")
    assert [o.members for o in objs] == [o.members for o in jobjs]
    assert objs and objs[0].get("a") == "hello"


def test_nrbf_null_multiple_zero_rejected():
    import struct

    stream = (
        b"\x00" + struct.pack("<iiii", 1, -1, 1, 0)
        + b"\x0c" + struct.pack("<i", 1) + _lp("L")
        + b"\x05" + struct.pack("<i", 1) + _lp("C") + struct.pack("<i", 2)
        + _lp("a") + _lp("b") + b"\x02\x02" + struct.pack("<i", 1)
        + b"\x0d\x00"  # ObjectNullMultiple256, count 0
        + _nrbf_prim_string(7, "x")
        + b"\x0b")
    with pytest.raises(tnrbf.NrbfError, match="count <= 0") as ei:
        tnrbf.NrbfReader(stream, 0).parse()
    with pytest.raises(jnrbf.NrbfError, match="count <= 0") as ej:
        jnrbf.NrbfReader(stream, 0).parse()
    assert str(ei.value) == str(ej.value)
