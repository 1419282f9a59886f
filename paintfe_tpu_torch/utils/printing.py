"""Print support: hand the flattened composite to the OS (the port's copy
of paintfe_tpu/utils/printing.py).

Behavioral contract: src/ops/print.rs — native path saves the composite to
`$TMPDIR/paintfe_print.png` and opens it with the platform default viewer
(:54-119); the wasm browser path is out of scope with the rest of the GUI.
Headless default: write the file and return its path without shelling out
(`open_viewer=True` opts into `xdg-open`/`open`/`start`).
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch


def print_image(composite, open_viewer: bool = False) -> pathlib.Path:
    """Save `composite` (u8 [H, W, 4]: a tensor on any device, downloaded
    once, or a numpy array) as the print temp PNG, with the JAX package's
    bytes; optionally open it with the OS default viewer.  Returns the
    written path."""
    from paintfe_tpu_torch.io import codecs

    if isinstance(composite, torch.Tensor):
        composite = composite.cpu().numpy()
    path = pathlib.Path(tempfile.gettempdir()) / "paintfe_print.png"
    codecs.save_image(np.asarray(composite, np.uint8), path, "png")
    if open_viewer:
        _open_with_os(path)
    return path


def _open_with_os(path: pathlib.Path):
    if sys.platform.startswith("win"):
        cmd = ["cmd", "/c", "start", "", str(path)]
    elif sys.platform == "darwin":
        cmd = ["open", str(path)]
    else:
        if shutil.which("xdg-open") is None:
            raise RuntimeError("no OS viewer available (xdg-open not found)")
        cmd = ["xdg-open", str(path)]
    subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
