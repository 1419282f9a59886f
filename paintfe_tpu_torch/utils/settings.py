"""Application settings: typed fields, JSON persistence, load-with-defaults.

Behavioral contract: src/config/settings.rs — ~90 typed fields serialized
as JSON in the OS config dir, loaded with defaults for missing/unknown
fields (forward + backward compatible), saved atomically.  This carries the
headless-relevant subset plus framework-specific knobs (device mesh, shard
policy).

The port's copy of paintfe_tpu/utils/settings.py: the same fields, JSON
and config directory, so one settings file reads the same in both
packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import List, Optional, Tuple


def default_config_dir() -> pathlib.Path:
    if os.name == "nt":  # pragma: no cover
        base = pathlib.Path(os.environ.get("APPDATA", "~")).expanduser()
    else:
        base = pathlib.Path(os.environ.get("XDG_CONFIG_HOME", "~/.config")).expanduser()
    return base / "PaintFE-TPU"


@dataclasses.dataclass
class AppSettings:
    # -- general -------------------------------------------------------------
    language: str = "en"
    theme: str = "dark"
    autosave_enabled: bool = True
    autosave_interval_minutes: int = 5
    max_recent_files: int = 10
    recent_files: List[str] = dataclasses.field(default_factory=list)

    # -- canvas / editing -----------------------------------------------------
    default_canvas_width: int = 1920
    default_canvas_height: int = 1080
    default_background: Tuple[int, int, int, int] = (255, 255, 255, 255)
    undo_memory_limit_mb: int = 512
    brush_size: float = 10.0
    brush_hardness: float = 1.0
    brush_anti_aliased: bool = True
    selection_feather_default: float = 0.0

    # -- export ---------------------------------------------------------------
    jpeg_quality: int = 90
    webp_lossless: bool = True
    tiff_compression: str = "none"
    gif_fps: float = 10.0

    # -- performance / device ---------------------------------------------------
    shard_batches: bool = True
    batch_bucket_by_shape: bool = True
    preview_max_edge: int = 1024
    profile_stages: bool = False

    # -- script engine -----------------------------------------------------------
    script_max_operations: int = 50_000_000
    script_max_call_depth: int = 64

    def save(self, path: Optional[pathlib.Path] = None):
        """Atomic JSON write."""
        path = pathlib.Path(path) if path else default_config_dir() / "settings.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        data = json.dumps(dataclasses.asdict(self), indent=2)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: Optional[pathlib.Path] = None) -> "AppSettings":
        """Load with defaults: missing fields default, unknown fields ignored."""
        path = pathlib.Path(path) if path else default_config_dir() / "settings.json"
        settings = cls()
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return settings
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in data.items():
            if key not in fields:
                continue
            if key == "default_background" and isinstance(value, list):
                value = tuple(value)
            # type-validate against the default's type (the reference's
            # serde load falls back to defaults for malformed fields; a
            # hand-edited "5" string must not land in a numeric field and
            # explode far from the load site)
            default = getattr(settings, key)
            if isinstance(default, bool):
                ok = isinstance(value, bool)
            elif isinstance(default, int):
                # int fields must stay int (2.5 in max_recent_files would
                # explode later in range()/indexing, far from here)
                ok = isinstance(value, int) and not isinstance(value, bool)
            elif isinstance(default, float):
                ok = isinstance(value, (int, float)) and not isinstance(value, bool)
                if ok:
                    value = float(value)
            elif isinstance(default, tuple):
                # container SHAPE validation too: a 3-element background
                # or string members would crash np.asarray far from here
                ok = (isinstance(value, tuple)
                      and len(value) == len(default)
                      and all(isinstance(v, int) and not isinstance(v, bool)
                              and 0 <= v <= 255 for v in value))
            else:
                ok = isinstance(value, type(default))
            if ok:
                setattr(settings, key, value)
        return settings
