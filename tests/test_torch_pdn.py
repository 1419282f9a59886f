"""The port's Paint.NET import (paintfe_tpu_torch.io.nrbf, io.pdn) against
the JAX package's, on .pdn documents written from seeds by chip_smoke's
pdn_bytes, and the port's CLI on them against the JAX CLI.  Tolerance 0
(bytes) throughout."""

import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from paintfe_tpu import cli as jcli
from paintfe_tpu.io import pdn as jpdn
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch.io import pdn as tpdn
from paintfe_tpu_torch.io.nrbf import NrbfError, NrbfReader

BLENDS = ["Normal", "Multiply", "Screen", "Overlay", "Additive", "ColorBurn",
          "Difference", "Xor", "Unknown"]


def _lp(s):
    b = s.encode()
    return bytes([len(b)]) + b


def _prim_string(object_id, s):
    return b"\x06" + struct.pack("<i", object_id) + _lp(s)


def test_nrbf_binary_library_in_a_member_slot():
    """memberReference = BinaryLibrary? + value: the formatter emits a
    library record before the first class of each new assembly, which can
    land inside a member slot; the value is the record after it."""
    stream = (
        b"\x00" + struct.pack("<iiii", 1, -1, 1, 0)
        + b"\x0c" + struct.pack("<i", 1) + _lp("Lib1")
        + b"\x05" + struct.pack("<i", 1) + _lp("C") + struct.pack("<i", 1)
        + _lp("a") + b"\x02" + struct.pack("<i", 1)
        + b"\x0c" + struct.pack("<i", 2) + _lp("Lib2")
        + _prim_string(7, "hello")
        + b"\x0b")
    objs = NrbfReader(stream, 0).parse().find_instances("C")
    assert objs and objs[0].get("a") == "hello"


def test_nrbf_null_multiple_zero_is_refused():
    stream = (
        b"\x00" + struct.pack("<iiii", 1, -1, 1, 0)
        + b"\x0c" + struct.pack("<i", 1) + _lp("L")
        + b"\x05" + struct.pack("<i", 1) + _lp("C") + struct.pack("<i", 2)
        + _lp("a") + _lp("b") + b"\x02\x02" + struct.pack("<i", 1)
        + b"\x0d\x00"
        + _prim_string(7, "x")
        + b"\x0b")
    with pytest.raises(NrbfError, match="count <= 0"):
        NrbfReader(stream, 0).parse()


def test_nrbf_null_multiple_fills_the_slots():
    stream = (
        b"\x00" + struct.pack("<iiii", 1, -1, 1, 0)
        + b"\x05" + struct.pack("<i", 1) + _lp("C") + struct.pack("<i", 3)
        + _lp("a") + _lp("b") + _lp("c") + b"\x02\x02\x02" + struct.pack("<i", 1)
        + b"\x0d\x02" + _prim_string(7, "z")
        + b"\x0b")
    obj = NrbfReader(stream, 0).parse().find_instances("C")[0]
    assert obj.members == {"a": None, "b": None, "c": "z"}


def _layers(seed, h, w, n):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        px = rng.integers(0, 256, (h, w, 4), np.uint8)
        px[: h // 4, : w // 3, 3] = 0  # a clear corner
        out.append(dict(name=f"layer {k} ü", pixels=px, visible=k != 2,
                        opacity=255 - 31 * k, blend=BLENDS[k % len(BLENDS)]))
    return out


def _write(path, layers, h, w, **kw):
    path.write_bytes(chip_smoke.pdn_bytes(layers, w, h, **kw))


@pytest.mark.parametrize("n,chunk,pad", [(1, 1 << 18, 0), (4, 777, 12), (9, 4096, 4)])
def test_load_pdn_matches_jax(tmp_path, n, chunk, pad):
    h, w = 29, 41
    layers = _layers(n, h, w, n)
    _write(tmp_path / "d.pdn", layers, h, w, chunk=chunk, stride_pad=pad)
    t, j = tpdn.load_pdn(tmp_path / "d.pdn"), jpdn.load_pdn(tmp_path / "d.pdn")
    assert (t.width, t.height, t.active_layer_index) == (j.width, j.height,
                                                          j.active_layer_index)
    assert len(t.layers) == len(j.layers) == n
    for tl, jl, spec in zip(t.layers, j.layers, layers):
        assert (tl.name, tl.visible, tl.opacity) == (jl.name, jl.visible, jl.opacity)
        assert int(tl.blend_mode) == int(jl.blend_mode)
        np.testing.assert_array_equal(tl.pixels, jl.pixels)
        np.testing.assert_array_equal(tl.pixels, spec["pixels"])
    assert tpdn.read_header(tmp_path / "d.pdn") == jpdn.read_header(tmp_path / "d.pdn")


@pytest.mark.parametrize("name", BLENDS)
def test_blend_op_classes_map_as_in_jax(name):
    cls = f"PaintDotNet.UserBlendOps+{name}BlendOp"
    assert int(tpdn._blend_from_op_class(cls)) == int(jpdn._blend_from_op_class(cls))


@pytest.mark.parametrize("cut", ["magic", "header", "graph", "payload", "gzip", "length"])
def test_corrupt_documents_raise_pdn_error(tmp_path, cut):
    h, w = 9, 11
    blob = bytearray(chip_smoke.pdn_bytes(_layers(3, h, w, 2), w, h, chunk=64))
    hlen = blob[4] | blob[5] << 8 | blob[6] << 16
    body = 7 + hlen + 2
    if cut == "magic":
        blob[:4] = b"PDN2"
    elif cut == "header":
        blob = blob[:5]
    elif cut == "graph":
        blob = blob[:body + 60]
    elif cut == "payload":
        blob = blob[:-40]
    elif cut == "gzip":
        blob[-30] ^= 0xFF
    else:  # a wrong deferred length: cut one 64-byte chunk out of the stream
        blob = blob[:len(blob) // 2] + blob[len(blob) // 2 + 9:]
    (tmp_path / "bad.pdn").write_bytes(bytes(blob))
    with pytest.raises(tpdn.PdnError):
        tpdn.load_pdn(tmp_path / "bad.pdn")
    with pytest.raises(jpdn.PdnError):
        jpdn.load_pdn(tmp_path / "bad.pdn")


def test_the_external_host_is_the_fallback(tmp_path, monkeypatch):
    """PAINTFE_PDN_HOST decodes what the native reader refuses: layer PNGs
    and a manifest, as for the JAX package."""
    host = tmp_path / "host.py"
    host.write_text(
        "import json, sys\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "out = sys.argv[3]\n"
        "Image.fromarray(np.full((5, 6, 4), 77, np.uint8), 'RGBA').save(out + '/layer_00.png')\n"
        "json.dump([{'name': 'h', 'opacity': 0.5, 'blend_mode': 'Screen'}],"
        " open(out + '/layers.json', 'w'))\n")
    host.chmod(0o755)
    wrapper = tmp_path / "host.sh"
    wrapper.write_text(f"#!/bin/sh\nexec {__import__('sys').executable} {host} \"$@\"\n")
    wrapper.chmod(0o755)
    (tmp_path / "odd.pdn").write_bytes(b"PDN3\x00\x00\x00")
    monkeypatch.setenv("PAINTFE_PDN_HOST", str(wrapper))
    t, j = tpdn.load_pdn(tmp_path / "odd.pdn"), jpdn.load_pdn(tmp_path / "odd.pdn")
    assert [(l.name, l.opacity, int(l.blend_mode)) for l in t.layers] == \
        [(l.name, l.opacity, int(l.blend_mode)) for l in j.layers] == [("h", 0.5, 2)]
    np.testing.assert_array_equal(t.layers[0].pixels, j.layers[0].pixels)


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("script", ["apply_blur(1.5); flip_canvas_vertical();", None])
def test_cli_on_pdn_matches_jax_cli(tmp_path, shard, script):
    """Layered .pdn documents through both CLIs, flattened to PNG and
    written back as .pfe: the same bytes."""
    h, w = 34, 47
    _write(tmp_path / "a.pdn", _layers(7, h, w, 6), h, w, chunk=2000)
    _write(tmp_path / "b.pdn", _layers(8, 20, 30, 3), 20, 30)
    for fmt in ("png", "pfe"):
        common = ["-i", str(tmp_path / "*.pdn"), "-f", fmt]
        if script is not None:
            (tmp_path / "fx.rhai").write_text(script)
            common += ["-s", str(tmp_path / "fx.rhai")]
        extra = ["--shard"] if shard else []
        assert jcli.main(common + ["--output-dir", str(tmp_path / f"jax_{fmt}"), *extra]) == 0
        assert tcli.main(common + ["--output-dir", str(tmp_path / f"port_{fmt}"),
                                   "--device", "cpu", *extra]) == 0
        for name in ("a", "b"):
            assert ((tmp_path / f"port_{fmt}" / f"{name}.{fmt}").read_bytes()
                    == (tmp_path / f"jax_{fmt}" / f"{name}.{fmt}").read_bytes()), name


@pytest.mark.parametrize("shard", [False, True])
def test_a_corrupt_pdn_fails_only_itself(tmp_path, capsys, shard):
    """A corrupt .pdn beside a good PNG: rc 1, the PNG still written, as
    the JAX CLI does (PdnError is a keep-going error)."""
    blob = chip_smoke.pdn_bytes(_layers(9, 8, 8, 2), 8, 8)
    (tmp_path / "bad.pdn").write_bytes(blob[:len(blob) - 50])
    (tmp_path / "graph.pdn").write_bytes(blob[:60])
    Image.fromarray(np.full((6, 7, 4), 99, np.uint8), "RGBA").save(tmp_path / "good.png")
    argv = ["-i", str(tmp_path / "bad.pdn"), str(tmp_path / "graph.pdn"),
            str(tmp_path / "good.png"), "--output-dir", str(tmp_path / "o"),
            *(["--shard"] if shard else [])]
    assert jcli.main(argv + ["--output-dir", str(tmp_path / "j")]) == 1
    assert tcli.main(argv + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "failed to decode .pdn" in err or "failed to parse .pdn" in err
    assert (tmp_path / "o" / "good.png").exists()
    assert not (tmp_path / "o" / "bad.png").exists()
