"""Internal clipboard: copy / cut / paste of selections and layers
(paintfe_tpu.ops.clipboard counterpart: host numpy and the same OS
bridge, copied as they are).

Behavioral contract: src/ops/clipboard.rs — internal RGBA clipboard with
selection-aware copy (unselected pixels transparent), cut = copy + delete,
paste as new layer.  The OS bridge (arboard in the reference) is a
best-effort shell-out to the platform clipboard tools (wl-clipboard on
Wayland, xclip on X11 — xsel is text-only and cannot carry image/png
targets, so it is deliberately not a fallback) with the image carried as
PNG; when no tool or display is available the bridge reports unavailable
and the internal clipboard still works.
"""

from __future__ import annotations

import io as _io
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from paintfe_tpu_torch.core.canvas import Canvas, Layer
from paintfe_tpu_torch.core.selection import delete_selected


# ---------------------------------------------------------------------------
# OS clipboard bridge (clipboard.rs / arboard analogue)
# ---------------------------------------------------------------------------

_COPY_TOOLS: List[List[str]] = [
    ["wl-copy", "-t", "image/png"],
    ["xclip", "-selection", "clipboard", "-t", "image/png", "-i"],
]
_PASTE_TOOLS: List[List[str]] = [
    ["wl-paste", "-t", "image/png"],
    ["xclip", "-selection", "clipboard", "-t", "image/png", "-o"],
]


def _find_tool(candidates: List[List[str]]) -> Optional[List[str]]:
    for cmd in candidates:
        if shutil.which(cmd[0]):
            return cmd
    return None


def os_clipboard_available() -> bool:
    """True when both a copy and a paste tool exist on PATH."""
    return _find_tool(_COPY_TOOLS) is not None and _find_tool(_PASTE_TOOLS) is not None


def os_copy_image(img: np.ndarray, timeout: float = 5.0) -> bool:
    """Put an RGBA u8 image on the OS clipboard as PNG; False if no tool,
    no display, or the tool failed."""
    cmd = _find_tool(_COPY_TOOLS)
    if cmd is None:
        return False
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8), "RGBA").save(buf, format="PNG")
    try:
        proc = subprocess.run(cmd, input=buf.getvalue(), capture_output=True,
                              timeout=timeout)
        return proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def os_paste_image(timeout: float = 5.0) -> Optional[np.ndarray]:
    """Read an image off the OS clipboard; None when unavailable/empty."""
    cmd = _find_tool(_PASTE_TOOLS)
    if cmd is None:
        return None
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not proc.stdout:
        return None
    from PIL import Image

    try:
        with Image.open(_io.BytesIO(proc.stdout)) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    except Exception:
        return None


class Clipboard:
    def __init__(self):
        self.image: Optional[np.ndarray] = None  # u8 [H, W, 4]
        self.origin: Tuple[int, int] = (0, 0)

    def has_content(self) -> bool:
        return self.image is not None

    def copy(self, canvas: Canvas, layer_idx: Optional[int] = None):
        """Copy the active (or given) layer's selected pixels; crops to the
        selection bbox, unselected pixels transparent."""
        idx = canvas.active_layer_index if layer_idx is None else layer_idx
        pixels = canvas.layers[idx].pixels
        if canvas.selection is None:
            self.image = pixels.copy()
            self.origin = (0, 0)
            return
        sel = canvas.selection > 0
        if not sel.any():
            # reference copy_selection returns false and leaves the
            # clipboard INTACT (clipboard.rs:660-662) — an empty selection
            # must not clobber previously copied content
            return
        ys, xs = np.nonzero(sel)
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        x0, x1 = int(xs.min()), int(xs.max()) + 1
        region = pixels[y0:y1, x0:x1].copy()
        region[~sel[y0:y1, x0:x1]] = 0
        self.image = region
        self.origin = (x0, y0)

    def cut(self, canvas: Canvas, layer_idx: Optional[int] = None):
        idx = canvas.active_layer_index if layer_idx is None else layer_idx
        self.copy(canvas, idx)
        canvas.layers[idx].pixels = delete_selected(
            canvas.layers[idx].pixels, canvas.selection
        )
        # the reference auto-deselects after a cut (clipboard.rs:720)
        canvas.selection = None

    def paste_as_layer(self, canvas: Canvas, at: Optional[Tuple[int, int]] = None) -> Optional[int]:
        """Paste as a new layer above the active one; returns its index."""
        if self.image is None:
            return None
        px = np.zeros((canvas.height, canvas.width, 4), np.uint8)
        ox, oy = self.origin if at is None else at
        ih, iw = self.image.shape[:2]
        x0, y0 = max(ox, 0), max(oy, 0)
        sx0, sy0 = x0 - ox, y0 - oy
        cw = min(iw - sx0, canvas.width - x0)
        ch = min(ih - sy0, canvas.height - y0)
        if cw > 0 and ch > 0:
            px[y0 : y0 + ch, x0 : x0 + cw] = self.image[sy0 : sy0 + ch, sx0 : sx0 + cw]
        layer = Layer(name="Pasted Layer", pixels=px)
        idx = min(canvas.active_layer_index + 1, len(canvas.layers))
        canvas.layers.insert(idx, layer)
        canvas.active_layer_index = idx
        return idx

    # -- OS bridge -----------------------------------------------------

    def copy_to_os(self) -> bool:
        """Push the internal clipboard image to the OS clipboard."""
        if self.image is None:
            return False
        return os_copy_image(self.image)

    def paste_from_os(self) -> bool:
        """Pull the OS clipboard image into the internal clipboard."""
        img = os_paste_image()
        if img is None:
            return False
        self.image = img
        self.origin = (0, 0)
        return True
