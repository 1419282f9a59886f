"""Runtime services: print hand-off, single-instance IPC, keybindings.

Behavioral contracts:
  * src/ops/print.rs — "print" = save the composite to a temp PNG and hand
    it to the OS viewer/printer (xdg-open / open / ShellExecute).
  * src/ipc.rs — single-instance guard: the first instance listens, later
    instances forward their file paths and exit (named pipe on Windows; a
    Unix socket here).
  * src/config/keybindings.rs — action -> key-combo map with JSON
    persistence and defaults.

The port's copy of paintfe_tpu/utils/runtime_services.py: the same socket
name, protocol and keybindings JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import socket
import tempfile
import threading
from typing import Callable, Dict, List, Optional


# ---------------------------------------------------------------------------
# Print
# ---------------------------------------------------------------------------


def print_image(composite, opener: Optional[Callable] = None) -> pathlib.Path:
    """Save the composite (u8 [H, W, 4]: a tensor on any device, or a numpy
    array) to a temp PNG and hand it to the OS default handler.  Returns
    the temp path; `opener` overrides the OS launcher (tests pass a stub;
    headless boxes have no viewer).

    Thin adapter over utils.printing.print_image — ONE implementation of
    the print.rs contract."""
    from paintfe_tpu_torch.utils import printing

    if opener is not None:
        path = printing.print_image(composite, open_viewer=False)
        opener(path)
        return path
    return printing.print_image(composite, open_viewer=True)


# ---------------------------------------------------------------------------
# Single-instance IPC
# ---------------------------------------------------------------------------


class SingleInstance:
    """First instance binds a Unix socket and receives file paths; later
    instances forward their paths and report not-primary."""

    def __init__(self, socket_path: Optional[str] = None):
        self.socket_path = socket_path or os.path.join(
            tempfile.gettempdir(), f"paintfe-tpu-{os.getuid()}.sock"
        )
        self.server: Optional[socket.socket] = None
        self.received: List[str] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def try_acquire(self) -> bool:
        """True if we became the primary instance.

        Claim order is BIND-first (atomic: two racing starters cannot both
        win — the loser's bind raises EADDRINUSE); only after a bind
        failure do we probe with connect to distinguish a live primary
        from a stale socket file left by a crash."""
        if self._bind():
            return True

        def _listening() -> bool:
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(self.socket_path)
                return True
            except (ConnectionRefusedError, FileNotFoundError):
                return False
            finally:
                probe.close()

        # bind failed: live primary, or a stale file from a crashed one?
        if _listening():
            return False
        # Stale-recovery must serialize: two concurrent starters could
        # otherwise each probe-refused, then one unlink the OTHER's
        # freshly-bound socket (two primaries).  An flock around
        # [re-probe, unlink, bind] makes the loser see the winner.
        import fcntl

        with open(self.socket_path + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            if _listening():
                return False  # the lock winner bound while we waited
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass
            return self._bind()

    def _bind(self) -> bool:
        server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            server.bind(self.socket_path)
        except OSError:
            server.close()
            return False
        self.server = server
        self.server.listen(4)
        self.server.settimeout(0.2)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return True

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.server.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                # drain the stream to EOF: one recv() truncates messages
                # that arrive split or exceed the buffer
                chunks = []
                while True:
                    try:
                        data = conn.recv(65536)
                    except OSError:
                        break
                    if not data:
                        break
                    chunks.append(data)
                for line in b"".join(chunks).decode(errors="replace").splitlines():
                    if line.strip():
                        self.received.append(line.strip())

    def forward_files(self, paths: List[str]) -> bool:
        """Send paths to the primary instance; True on success."""
        try:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(self.socket_path)
            sock.sendall(("\n".join(str(p) for p in paths) + "\n").encode())
            sock.close()
            return True
        except OSError:
            return False

    def release(self):
        self._stop.set()
        if self.server is not None:
            try:
                self.server.close()
            except OSError:
                pass
            try:
                os.unlink(self.socket_path)
            except FileNotFoundError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=1)


# ---------------------------------------------------------------------------
# Keybindings
# ---------------------------------------------------------------------------

DEFAULT_KEYBINDINGS: Dict[str, str] = {
    "file.new": "Ctrl+N",
    "file.open": "Ctrl+O",
    "file.save": "Ctrl+S",
    "file.save_as": "Ctrl+Shift+S",
    "edit.undo": "Ctrl+Z",
    "edit.redo": "Ctrl+Y",
    "edit.copy": "Ctrl+C",
    "edit.cut": "Ctrl+X",
    "edit.paste": "Ctrl+V",
    "select.all": "Ctrl+A",
    "select.none": "Ctrl+D",
    "select.invert": "Ctrl+Shift+I",
    "layer.new": "Ctrl+Shift+N",
    "layer.duplicate": "Ctrl+J",
    "layer.merge_down": "Ctrl+E",
    "image.flip_horizontal": "Ctrl+Shift+H",
    "image.flip_vertical": "Ctrl+Shift+V",
    "tool.brush": "B",
    "tool.eraser": "E",
    "tool.fill": "G",
    "tool.wand": "W",
    "tool.text": "T",
    "view.zoom_in": "Ctrl+=",
    "view.zoom_out": "Ctrl+-",
    "view.fit": "Ctrl+0",
}


@dataclasses.dataclass
class Keybindings:
    bindings: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_KEYBINDINGS)
    )

    def rebind(self, action: str, combo: str):
        self.bindings[action] = combo

    def action_for(self, combo: str) -> Optional[str]:
        for action, c in self.bindings.items():
            if c.lower() == combo.lower():
                return action
        return None

    def save(self, path):
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.bindings, indent=2))

    @classmethod
    def load(cls, path) -> "Keybindings":
        kb = cls()
        try:
            data = json.loads(pathlib.Path(path).read_text())
        except (OSError, json.JSONDecodeError):
            return kb
        for action, combo in data.items():
            if isinstance(combo, str):
                kb.bindings[action] = combo
        return kb
