"""Open-document wrapper: canvas + history + file binding
(paintfe_tpu.core.project counterpart).

Behavioral contract: src/project.rs — a `Project` owns the CanvasState, its
HistoryManager, the backing path (None for untitled), the dirty flag, a
display name derived from the path or "Untitled-N", and animation metadata
preserved from GIF/APNG import (:10-98).  View state (zoom/pan) rides along
for session restore.

`device` is where every composite the project triggers runs (the save's
flatten): the card unless the caller passes "cpu".
"""

from __future__ import annotations

import dataclasses
import pathlib
import uuid
from typing import Optional, Tuple

from paintfe_tpu_torch.core.canvas import Canvas, Layer
from paintfe_tpu_torch.core.history import HistoryManager
from paintfe_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Project:
    canvas: Canvas
    history: HistoryManager
    path: Optional[pathlib.Path] = None
    is_dirty: bool = False
    name: str = "Untitled-1"
    was_animated: bool = False
    animation_fps: float = 10.0
    view_zoom: float = 1.0
    view_pan_offset: Tuple[float, float] = (0.0, 0.0)
    id: str = dataclasses.field(default_factory=lambda: str(uuid.uuid4()))
    device: str = "cuda"

    @classmethod
    def new_untitled(cls, untitled_counter: int, width: int, height: int,
                     history_limit: int = 50, device="cuda") -> "Project":
        return cls(
            canvas=Canvas.new(width, height),
            history=HistoryManager(max_entries=history_limit),
            name=f"Untitled-{untitled_counter}",
            device=str(resolve_device(device)),
        )

    @classmethod
    def open(cls, path, device="cuda") -> "Project":
        """Load a document from disk: .pfe keeps layers; animated formats
        keep their frame rate; everything else imports as one layer."""
        from paintfe_tpu_torch.io import codecs, pfe

        path = pathlib.Path(path)
        was_animated = False
        fps = 10.0
        if path.suffix.lower() == ".pfe":
            canvas = pfe.load_pfe(str(path))
        elif path.suffix.lower() == ".pdn":
            from paintfe_tpu_torch.io import pdn

            canvas = pdn.load_pdn(str(path))
        elif codecs.detect_animation(path):
            frames, delays = codecs.load_frames(path)
            canvas = Canvas.from_image(frames[0])
            for i, frame in enumerate(frames[1:], start=2):
                layer = Layer.new(f"Frame {i}", frame.shape[1], frame.shape[0])
                layer.pixels = frame
                layer.visible = False
                canvas.layers.append(layer)
            was_animated = True
            if delays and delays[0] > 0:
                fps = 1000.0 / float(delays[0])
        else:
            from paintfe_tpu_torch.io import deep_export

            deep = deep_export.load_deep_image(path)
            if deep is not None:
                # 16-bit PNG / 16/32-bit TIFF: keep the deep payload so a
                # re-export stays 16/32-bit (io.rs:588-640), like the CLI
                preview, pixel_format, buf = deep
                canvas = Canvas.from_image(preview)
                canvas.layers[0].pixel_format = pixel_format
                canvas.layers[0].deep_pixels = buf
            else:
                canvas = Canvas.from_image(codecs.load_image(path, device=device))
        return cls(
            canvas=canvas,
            history=HistoryManager(),
            path=path,
            name=path.stem,
            was_animated=was_animated,
            animation_fps=fps,
            device=str(resolve_device(device)),
        )

    def mark_dirty(self):
        self.is_dirty = True

    @property
    def title(self) -> str:
        return f"{self.name}*" if self.is_dirty else self.name

    def save(self, path=None):
        """Save as .pfe (layered) or flatten through the depth-aware export
        (the flatten on the project's device)."""
        from paintfe_tpu_torch.io import deep_export, pfe

        target = pathlib.Path(path) if path is not None else self.path
        if target is None:
            raise ValueError("project has no path; pass one explicitly")
        if target.suffix.lower() == ".pfe":
            pfe.save_pfe(self.canvas, str(target))
        else:
            prep = deep_export.prepare_export_image(self.canvas, device=self.device)
            deep_export.encode_prepared_and_write(
                prep, target, target.suffix.lstrip(".").lower() or "png"
            )
        self.path = target
        self.name = target.stem
        self.is_dirty = False
