"""Out-of-process effect plugin host.

Behavioral contract: src/paintdotnet_plugins.rs — plugins run as trusted
subprocesses for crash isolation, gated by a SHA-256 allowlist (:320-421),
speaking a describe/render RPC (:485-607).  The reference's host is a C#
process for Paint.NET DLLs; this host is language-agnostic: any executable
speaking the line-delimited JSON protocol below can provide effects.

Protocol (stdin/stdout, one JSON object per line):
  -> {"cmd": "describe"}
  <- {"name": ..., "effects": [{"id": ..., "name": ..., "params": [...]}]}
  -> {"cmd": "render", "effect": id, "width": W, "height": H,
      "params": {...}, "pixels_b64": base64 RGBA}
  <- {"ok": true, "pixels_b64": base64 RGBA}

The port's copy of paintfe_tpu/ops/plugins.py: the same protocol and
bytes (the .NET host in paintdotnet-host/ speaks it unchanged).  `render`
takes a u8 [H, W, 4] tensor on any device, downloads it once, and returns
the plugin's pixels as a u8 tensor on that device.
"""

from __future__ import annotations

import base64
import hashlib
import json
import pathlib
import subprocess
import threading
from typing import Dict, Optional

import numpy as np
import torch


class PluginError(Exception):
    pass


class TrustList:
    """SHA-256 allowlist of plugin executables (paintdotnet_plugins.rs:320-421)."""

    def __init__(self, path: Optional[pathlib.Path] = None):
        self.path = path
        self.hashes = set()
        if path is not None and pathlib.Path(path).exists():
            self.hashes = set(pathlib.Path(path).read_text().split())

    @staticmethod
    def digest(exe_path) -> str:
        return hashlib.sha256(pathlib.Path(exe_path).read_bytes()).hexdigest()

    def is_trusted(self, exe_path) -> bool:
        return self.digest(exe_path) in self.hashes

    def trust(self, exe_path):
        self.hashes.add(self.digest(exe_path))
        if self.path is not None:
            pathlib.Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            pathlib.Path(self.path).write_text("\n".join(sorted(self.hashes)))


class PluginHost:
    """One plugin subprocess; crash isolation comes free with the process
    boundary — a dying plugin raises PluginError, never takes us down."""

    def __init__(self, exe_path, trust: Optional[TrustList] = None,
                 timeout: float = 60.0, args=(), launcher=()):
        """`launcher` prefixes the command line (e.g. ("dotnet",) for the
        .NET host in paintdotnet-host/); `args` follow the executable
        (e.g. the plugin DLL path).  The trust list must cover the
        executable AND every argument that is an existing file — the
        plugin DLL handed to the .NET host is the code that actually
        runs, and the reference hashes the plugin file itself
        (paintdotnet_plugins.rs:236-287)."""
        exe_path = pathlib.Path(exe_path)
        if not exe_path.exists():
            raise PluginError(f"plugin not found: {exe_path}")
        if trust is not None:
            for target in [exe_path] + [pathlib.Path(a) for a in args
                                        if pathlib.Path(str(a)).is_file()]:
                if not trust.is_trusted(target):
                    raise PluginError(
                        f"plugin not in the trust list: {target}")
        self.exe_path = exe_path
        self.timeout = timeout
        self.args = [str(a) for a in args]
        self.launcher = [str(x) for x in launcher]
        self.proc: Optional[subprocess.Popen] = None

    def _ensure(self):
        if self.proc is None or self.proc.poll() is not None:
            self.proc = subprocess.Popen(
                self.launcher + [str(self.exe_path)] + self.args,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            )

    def _read_response_line(self) -> bytes:
        """Blocking readline bounded by self.timeout: an unresponsive plugin
        (deadlock, infinite loop) is killed and surfaces as PluginError
        instead of hanging the host — the crash-isolation contract.  One
        readline on a thread: a 4K frame's reply is one line of about
        44 MB of base64."""
        result = {}

        def reader():
            result["line"] = self.proc.stdout.readline()

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        t.join(self.timeout)
        if t.is_alive():
            self.close()  # kills the plugin; the reader sees EOF and exits
            raise PluginError(
                f"plugin unresponsive after {self.timeout:.0f}s (killed)")
        return result.get("line", b"")

    def _rpc(self, payload: dict) -> dict:
        self._ensure()
        try:
            self.proc.stdin.write((json.dumps(payload) + "\n").encode())
            self.proc.stdin.flush()
            line = self._read_response_line()
        except (BrokenPipeError, OSError) as e:
            raise PluginError(f"plugin crashed: {e}")
        if not line:
            raise PluginError("plugin closed the pipe (crash?)")
        try:
            return json.loads(line)
        except json.JSONDecodeError as e:
            raise PluginError(f"bad plugin response: {e}")

    def describe(self) -> dict:
        return self._rpc({"cmd": "describe"})

    def render(self, effect_id: str, pixels, params: Optional[Dict] = None) -> torch.Tensor:
        """Run `effect_id` on u8 [H, W, 4] `pixels` (a tensor on any
        device, downloaded once; a numpy array is taken as a CPU tensor);
        returns the plugin's pixels as a u8 tensor on `pixels`' device."""
        if not isinstance(pixels, torch.Tensor):
            pixels = torch.from_numpy(np.ascontiguousarray(pixels, np.uint8))
        device = pixels.device
        host = np.ascontiguousarray(pixels.cpu().numpy(), np.uint8)
        h, w = host.shape[:2]
        resp = self._rpc({
            "cmd": "render", "effect": effect_id, "width": w, "height": h,
            "params": params or {},
            "pixels_b64": base64.b64encode(host.tobytes()).decode(),
        })
        if not resp.get("ok"):
            raise PluginError(f"render failed: {resp.get('error', 'unknown')}")
        raw = base64.b64decode(resp["pixels_b64"])
        out = np.frombuffer(raw, np.uint8).reshape(h, w, 4).copy()
        return torch.from_numpy(out).to(device)

    def close(self):
        if self.proc is not None:
            try:
                self.proc.stdin.close()
                self.proc.terminate()
                self.proc.wait(timeout=5)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
            self.proc = None
