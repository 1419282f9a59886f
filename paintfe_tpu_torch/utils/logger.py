"""Session logger: one file, truncated per launch (the port's copy of
paintfe_tpu/utils/logger.py: the same directory, line format and
truncation, so both packages write one log the same way).

Behavioral contract: src/logger.rs — single session log in the user data
dir, truncated at init, timestamped level-tagged lines, I/O errors silently
ignored so logging never crashes the app.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import threading
from typing import Optional

_lock = threading.Lock()
_file = None
_path: Optional[pathlib.Path] = None


def default_log_dir() -> pathlib.Path:
    if os.name == "nt":  # pragma: no cover
        base = pathlib.Path(os.environ.get("APPDATA", "~")).expanduser()
    else:
        base = pathlib.Path(
            os.environ.get("XDG_DATA_HOME", "~/.local/share")
        ).expanduser()
    return base / "PaintFE-TPU"


def init(path: Optional[pathlib.Path] = None):
    """Open (truncate) the session log."""
    global _file, _path
    with _lock:
        if _file is not None:  # re-init must not leak the old handle
            try:
                _file.close()
            except OSError:
                pass
            _file = None
        try:
            _path = pathlib.Path(path) if path else default_log_dir() / "paintfe.log"
            _path.parent.mkdir(parents=True, exist_ok=True)
            _file = open(_path, "w")
        except OSError:
            _file = None


def log_path() -> Optional[pathlib.Path]:
    return _path


def write_line(line: str):
    with _lock:
        if _file is not None:
            try:
                _file.write(line + "\n")
                _file.flush()
            except OSError:
                pass


def write(level: str, msg: str):
    ts = datetime.datetime.now().strftime("%H:%M:%S.%f")[:-3]
    write_line(f"[{ts}] [{level}] {msg}")


def log_info(msg: str):
    write("INFO", msg)


def log_warn(msg: str):
    write("WARN", msg)


def log_err(msg: str):
    write("ERROR", msg)
