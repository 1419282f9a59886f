"""Autosave: periodic PFE snapshots to the user data dir.

Behavioral contract: src/io.rs:527 (autosave_dir) + settings-driven interval
(config/settings.rs:52-53).  The PFE container *is* the checkpoint format
(SURVEY §5 checkpoint/resume): autosaves are full project files that reopen
losslessly.

The port's copy of paintfe_tpu/utils/autosave.py: the document's layers
are host arrays, written through the port's io/pfe.save_pfe with the JAX
package's bytes.
"""

from __future__ import annotations

import pathlib
import time
from typing import Optional

from paintfe_tpu_torch.io import pfe
from paintfe_tpu_torch.utils.logger import default_log_dir


def autosave_dir() -> pathlib.Path:
    return default_log_dir() / "autosave"


def _safe_name(name: str) -> str:
    """Project name -> filename component: non-[alnum-_] chars map to '_'
    (lifecycle_async.rs:90-100) — 'my/project' must not create or escape
    directories."""
    return "".join(c if (c.isalnum() or c in "-_") else "_" for c in name)


class Autosaver:
    def __init__(self, interval_minutes: float = 5.0, directory=None):
        self.interval = interval_minutes * 60.0
        self.directory = pathlib.Path(directory) if directory else autosave_dir()
        # seed at construction like the reference's last_autosave =
        # Instant::now(): the first save lands after one full interval,
        # not immediately at startup
        self.last_save: Optional[float] = time.time()

    def maybe_save(self, canvas, name: str = "untitled") -> Optional[pathlib.Path]:
        """Save if the interval has elapsed; returns the path when saved.
        An interval of 0 means DISABLED (the reference's interval_secs > 0
        guard), not save-every-call."""
        if self.interval <= 0:
            return None
        now = time.time()
        if self.last_save is not None and now - self.last_save < self.interval:
            return None
        return self.save_now(canvas, name)

    def save_now(self, canvas, name: str = "untitled") -> pathlib.Path:
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self.directory / f"{_safe_name(name)}.autosave.pfe"
        pfe.save_pfe(canvas, str(path))
        self.last_save = time.time()
        return path

    def list_autosaves(self):
        if not self.directory.exists():
            return []
        return sorted(self.directory.glob("*.autosave.pfe"))
