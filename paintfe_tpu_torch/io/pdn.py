"""Paint.NET .pdn import (read-only).

Behavioral contract: src/pdn.rs — the reference parses .pdn *out of process*
via a C# host (the payload is .NET BinaryFormatter data, pdn.rs:40-160) and
maps Paint.NET blend-mode names onto PaintFE modes (:162-184).

This module decodes .pdn documents NATIVELY: the container header (magic +
XML), the .NET BinaryFormatter object graph (io/nrbf.py — Document ->
BitmapLayer -> LayerProperties/BitmapLayerProperties/Surface/MemoryBlock),
and Paint.NET's DeferredFormatter payload that follows the NRBF stream
(per deferred MemoryBlock: u8 format version, u32-BE chunk size, then
{u32-BE chunk number, u32-BE byte count, gzip data} chunks; pixels are
BGRA rows at the surface stride).  An external helper (PAINTFE_PDN_HOST,
`host decode <file.pdn> <out_dir>` writing layer_NN.png + layers.json)
remains as a fallback for exotic graphs the native reader rejects.
Host code: the counterpart of paintfe_tpu.io.pdn, which the port imports
nothing of; the layers it returns flatten on K-composite like any other
document's.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import tempfile
from typing import Optional

import numpy as np

from paintfe_tpu_torch.core.blend import BlendMode
from paintfe_tpu_torch.core.canvas import Canvas, Layer


class PdnError(Exception):
    pass


# Paint.NET blend-mode name -> PaintFE mode (pdn.rs:162-184); unknown -> Normal.
PDN_BLEND_MODES = {
    "Multiply": BlendMode.MULTIPLY,
    "Additive": BlendMode.ADDITIVE,
    "ColorBurn": BlendMode.COLOR_BURN,
    "ColorDodge": BlendMode.COLOR_DODGE,
    "Reflect": BlendMode.REFLECT,
    "Glow": BlendMode.GLOW,
    "Overlay": BlendMode.OVERLAY,
    "Difference": BlendMode.DIFFERENCE,
    "Negation": BlendMode.NEGATION,
    "Lighten": BlendMode.LIGHTEN,
    "Darken": BlendMode.DARKEN,
    "Screen": BlendMode.SCREEN,
    "Xor": BlendMode.XOR,
}


def map_blend_mode(name: str) -> BlendMode:
    return PDN_BLEND_MODES.get(name, BlendMode.NORMAL)


def read_header(path) -> dict:
    """Parse the .pdn magic + XML header (dimensions, layer metadata)."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(b"PDN3"):
        raise PdnError("not a Paint.NET file (missing PDN3 magic)")
    if len(data) < 7:
        raise PdnError("truncated .pdn header")
    # 3-byte little-endian XML header length follows the magic
    n = data[4] | (data[5] << 8) | (data[6] << 16)
    xml = data[7 : 7 + n].decode("utf-8", errors="replace")
    out = {"width": None, "height": None, "layers": []}
    m = re.search(r'width="(\d+)"', xml)
    if m:
        out["width"] = int(m.group(1))
    m = re.search(r'height="(\d+)"', xml)
    if m:
        out["height"] = int(m.group(1))
    for lm in re.finditer(r"<layer\b([^>]*)>", xml):
        attrs = dict(re.findall(r'(\w+)="([^"]*)"', lm.group(1)))
        out["layers"].append(attrs)
    return out


def _blend_from_op_class(class_name: str) -> BlendMode:
    """'PaintDotNet.UserBlendOps+AdditiveBlendOp' -> BlendMode.ADDITIVE."""
    tail = class_name.rsplit("+", 1)[-1]
    if tail.endswith("BlendOp"):
        tail = tail[: -len("BlendOp")]
    return map_blend_mode(tail)


def _read_deferred(data: bytes, pos: int, length: int) -> bytes:
    """One DeferredFormatter object payload; returns (bytes, new_pos)."""
    import gzip
    import struct

    version = data[pos]
    pos += 1
    pos += 4  # chunk size (informational; chunk headers carry byte counts)
    chunks = {}
    total = 0
    while total < length:
        chunk_no, size = struct.unpack(">II", data[pos:pos + 8])
        pos += 8
        blob = data[pos:pos + size]
        pos += size
        if version == 0:
            blob = gzip.decompress(blob)
        chunks[chunk_no] = blob
        total += len(blob)
    out = b"".join(chunks[k] for k in sorted(chunks))
    if len(out) != length:
        raise PdnError("deferred payload length mismatch")
    return out, pos


def load_pdn_native(path) -> Canvas:
    """Decode a .pdn fully in-process (no external host).

    Every decode failure surfaces as PdnError — corrupt deferred payloads,
    missing members, bad gzip, or stride/shape mismatches raise
    struct.error / TypeError / ValueError deep inside; load_pdn's
    `except PdnError` (the external-host fallback trigger) must see them
    all, not a raw traceback."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(b"PDN3"):
        raise PdnError("not a Paint.NET file (missing PDN3 magic)")
    try:
        return _decode_pdn(data)
    except PdnError:
        raise
    except Exception as e:  # noqa: BLE001 - surface as a PdnError
        raise PdnError(f"failed to decode .pdn: {type(e).__name__}: {e}")


def _decode_pdn(data: bytes) -> Canvas:
    from paintfe_tpu_torch.io.nrbf import NrbfObject, NrbfReader

    hlen = data[4] | (data[5] << 8) | (data[6] << 16)
    body_off = 7 + hlen + 2  # skip the 2-byte deferred-format marker
    try:
        reader = NrbfReader(data, body_off).parse()
    except Exception as e:  # noqa: BLE001 - surface as a PdnError
        raise PdnError(f"failed to parse .pdn object graph: {e}")

    bitmap_layers = [
        o for o in reader.find_instances("PaintDotNet.BitmapLayer")
        if "surface" in o.members
    ]
    if not bitmap_layers:
        raise PdnError(".pdn document contains no bitmap layers")

    # DeferredFormatter payloads follow MessageEnd in MemoryBlock stream order
    deferred_blocks = [
        o for o in reader.find_instances("MemoryBlock")
        if o.get("deferred") and not o.get("hasParent")
    ]
    pos = reader.end_pos
    payloads = {}
    for block in deferred_blocks:
        payload, pos = _read_deferred(data, pos, int(block.get("length64")))
        payloads[id(block)] = payload

    canvas: Optional[Canvas] = None
    for bl in bitmap_layers:
        surface = bl.get("surface")
        if not isinstance(surface, NrbfObject):
            raise PdnError(".pdn layer has no surface")
        w = int(surface.get("width"))
        h = int(surface.get("height"))
        stride = int(surface.get("stride", w * 4))
        block = surface.get("scan0")
        raw = payloads.get(id(block))
        if raw is None:
            raise PdnError(".pdn surface pixels missing from deferred data")
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride)[:, : w * 4]
        bgra = rows.reshape(h, w, 4)
        rgba = bgra[..., [2, 1, 0, 3]].copy()

        props = bl.get("Layer+properties")
        name = "Layer"
        visible = True
        opacity = 255
        if isinstance(props, NrbfObject):
            name = props.get("name", name)
            visible = bool(props.get("visible", True))
            opacity = int(props.get("opacity", 255))
        blend = BlendMode.NORMAL
        blp = bl.get("properties")
        if isinstance(blp, NrbfObject):
            op = blp.get("blendOp")
            if isinstance(op, NrbfObject):
                blend = _blend_from_op_class(op.class_name)

        if canvas is None:
            canvas = Canvas(width=w, height=h)
        canvas.layers.append(Layer(
            name=str(name),
            pixels=rgba,
            visible=visible,
            opacity=opacity / 255.0,
            blend_mode=blend,
        ))
    canvas.active_layer_index = len(canvas.layers) - 1
    return canvas


def load_pdn(path) -> Canvas:
    """Import a .pdn document: native decode first (io/nrbf.py), external
    helper (PAINTFE_PDN_HOST) as the fallback for graphs it can't walk."""
    host = os.environ.get("PAINTFE_PDN_HOST")
    try:
        return load_pdn_native(path)
    except PdnError:
        if not host:
            raise
    from paintfe_tpu_torch.io import codecs

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [host, "decode", str(path), tmp], capture_output=True, timeout=120
        )
        if proc.returncode != 0:
            raise PdnError(
                f"pdn host failed ({proc.returncode}): "
                f"{proc.stderr.decode(errors='replace')[:400]}"
            )
        manifest_path = pathlib.Path(tmp) / "layers.json"
        if not manifest_path.exists():
            raise PdnError("pdn host produced no layers.json manifest")
        manifest = json.loads(manifest_path.read_text())
        canvas: Optional[Canvas] = None
        for i, entry in enumerate(manifest):
            img = codecs.load_image(pathlib.Path(tmp) / f"layer_{i:02d}.png")
            if canvas is None:
                canvas = Canvas(width=img.shape[1], height=img.shape[0])
            canvas.layers.append(Layer(
                name=entry.get("name", f"Layer {i + 1}"),
                pixels=img,
                visible=bool(entry.get("visible", True)),
                opacity=float(entry.get("opacity", 1.0)),
                blend_mode=map_blend_mode(entry.get("blend_mode", "Normal")),
            ))
        if canvas is None:
            raise PdnError("pdn host produced no layers")
        return canvas
