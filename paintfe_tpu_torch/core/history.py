"""Tiered undo/redo (paintfe_tpu.core.history counterpart, host numpy).

Behavioral contract: src/components/history.rs — `Command` trait (:15),
`PixelPatch` changed-tile capture (:49-188), `LayerOpCommand` (:306-376),
full `SnapshotCommand` (:782-952), `SingleLayerSnapshotCommand` (:953), and
the `HistoryManager` ring with memory accounting (:638-780).

The cost model carries over: brush strokes store only changed 64x64 tiles;
layer ops store one layer; structural ops store the whole document.

Every command that changes pixels assigns a new array to the layer and
never writes into the one it holds: core/device.DeviceLayerCache
revalidates by host-array identity, so an in-place write would leave it
serving the upload from before the undo.  (The JAX package's
PixelPatch.undo/redo write the tiles in place, and its composite_device
is stale after an undo; ROADMAP C10.)
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np

from paintfe_tpu_torch.core.canvas import Canvas, Layer, TILE


class Command:
    name: str = "command"

    def undo(self, canvas: Canvas):  # pragma: no cover - interface
        raise NotImplementedError

    def redo(self, canvas: Canvas):  # pragma: no cover - interface
        raise NotImplementedError

    def memory_bytes(self) -> int:
        return 0


class PixelPatch(Command):
    """Tile-level diff of one layer: stores (tile coords, before, after)."""

    def __init__(self, name: str, layer_idx: int, before: np.ndarray,
                 after: np.ndarray):
        self.name = name
        self.layer_idx = layer_idx
        self.tiles: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        h, w = before.shape[:2]
        for ty in range(0, h, TILE):
            for tx in range(0, w, TILE):
                b = before[ty : ty + TILE, tx : tx + TILE]
                a = after[ty : ty + TILE, tx : tx + TILE]
                if not np.array_equal(b, a):
                    self.tiles.append((tx, ty, b.copy(), a.copy()))

    def _write(self, canvas: Canvas, which: int):
        # a fresh array with the tiles written, assigned: never in place
        layer = canvas.layers[self.layer_idx]
        px = layer.pixels.copy()
        for tx, ty, *pair in self.tiles:
            tile = pair[which]
            px[ty : ty + tile.shape[0], tx : tx + tile.shape[1]] = tile
        layer.pixels = px

    def undo(self, canvas: Canvas):
        self._write(canvas, 0)

    def redo(self, canvas: Canvas):
        self._write(canvas, 1)

    def memory_bytes(self) -> int:
        return sum(b.nbytes + a.nbytes for _, _, b, a in self.tiles)

    def is_empty(self) -> bool:
        return not self.tiles


class LayerOpCommand(Command):
    """Structural op on one layer: add / delete / duplicate."""

    def __init__(self, name: str, op: str, index: int, layer: Layer,
                 prev_active: int, new_active: int):
        self.name = name
        self.op = op  # 'add' or 'delete'
        self.index = index
        self.layer = layer.clone()
        self.prev_active = prev_active
        self.new_active = new_active

    def undo(self, canvas: Canvas):
        if self.op == "add":
            canvas.layers.pop(self.index)
        else:  # delete
            canvas.layers.insert(self.index, self.layer.clone())
        canvas.active_layer_index = self.prev_active

    def redo(self, canvas: Canvas):
        if self.op == "add":
            canvas.layers.insert(self.index, self.layer.clone())
        else:
            canvas.layers.pop(self.index)
        canvas.active_layer_index = self.new_active

    def memory_bytes(self) -> int:
        return self.layer.pixels.nbytes


class SingleLayerSnapshotCommand(Command):
    """Before/after snapshot of one layer's full pixels (filter apply)."""

    def __init__(self, name: str, layer_idx: int, before: np.ndarray,
                 after: np.ndarray):
        self.name = name
        self.layer_idx = layer_idx
        self.before = before.copy()
        self.after = after.copy()

    def undo(self, canvas: Canvas):
        canvas.layers[self.layer_idx].pixels = self.before.copy()

    def redo(self, canvas: Canvas):
        canvas.layers[self.layer_idx].pixels = self.after.copy()

    def memory_bytes(self) -> int:
        return self.before.nbytes + self.after.nbytes


def _canvas_snapshot(canvas: Canvas) -> dict:
    return {
        "width": canvas.width,
        "height": canvas.height,
        "layers": [l.clone() for l in canvas.layers],
        "folders": copy.deepcopy(canvas.folders),
        "active": canvas.active_layer_index,
        "selection": None if canvas.selection is None else canvas.selection.copy(),
    }


def _restore_snapshot(canvas: Canvas, snap: dict):
    canvas.width = snap["width"]
    canvas.height = snap["height"]
    canvas.layers = [l.clone() for l in snap["layers"]]
    canvas.folders = copy.deepcopy(snap["folders"])
    canvas.active_layer_index = snap["active"]
    canvas.selection = None if snap["selection"] is None else snap["selection"].copy()


class SnapshotCommand(Command):
    """Full-document snapshot (multi-layer structural ops)."""

    def __init__(self, name: str, canvas: Canvas):
        self.name = name
        self.before = _canvas_snapshot(canvas)
        self.after: Optional[dict] = None

    def finalize(self, canvas: Canvas):
        self.after = _canvas_snapshot(canvas)

    def undo(self, canvas: Canvas):
        _restore_snapshot(canvas, self.before)

    def redo(self, canvas: Canvas):
        if self.after is not None:
            _restore_snapshot(canvas, self.after)

    def memory_bytes(self) -> int:
        total = sum(l.pixels.nbytes for l in self.before["layers"])
        if self.after:
            total += sum(l.pixels.nbytes for l in self.after["layers"])
        return total


class HistoryManager:
    """Undo/redo stacks with a memory budget (history.rs:638-780)."""

    def __init__(self, max_entries: int = 50,
                 memory_limit_bytes: int = 100 * 1024 * 1024):
        # reference defaults: HistoryManager::new(50) + 100 MB
        # (components/history.rs:648-663); count is pruned first
        self.undo_stack: List[Command] = []
        self.redo_stack: List[Command] = []
        self.max_entries = max_entries
        self.memory_limit = memory_limit_bytes

    def push(self, command: Command):
        if isinstance(command, PixelPatch) and command.is_empty():
            return
        self.undo_stack.append(command)
        self.redo_stack.clear()
        self._trim()

    def _trim(self):
        while len(self.undo_stack) > self.max_entries:
            self.undo_stack.pop(0)
        while len(self.undo_stack) > 1 and self.memory_bytes() > self.memory_limit:
            self.undo_stack.pop(0)

    def memory_bytes(self) -> int:
        return sum(c.memory_bytes() for c in self.undo_stack + self.redo_stack)

    def can_undo(self) -> bool:
        return bool(self.undo_stack)

    def can_redo(self) -> bool:
        return bool(self.redo_stack)

    def undo(self, canvas: Canvas) -> bool:
        if not self.undo_stack:
            return False
        cmd = self.undo_stack.pop()
        cmd.undo(canvas)
        self.redo_stack.append(cmd)
        return True

    def redo(self, canvas: Canvas) -> bool:
        if not self.redo_stack:
            return False
        cmd = self.redo_stack.pop()
        cmd.redo(canvas)
        self.undo_stack.append(cmd)
        return True

    def clear(self):
        self.undo_stack.clear()
        self.redo_stack.clear()
