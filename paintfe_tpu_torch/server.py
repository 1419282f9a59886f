"""Serving daemon: a long-lived process that keeps the card warm (the
port's counterpart of paintfe_tpu/server.py).

The reference is a desktop app; its CLI pays full startup per invocation
(cli.rs:12-13 is explicitly single-shot).  For batch serving the expensive
parts — process start, CUDA context, the kernel and native libraries'
build or load — must be paid once and reused, so this daemon accepts
newline-delimited JSON jobs over a TCP socket:

    {"input": "a.png", "output": "out/a.png", "script": "fx.rhai",
     "format": "png", "quality": 90}
    -> {"ok": true, "output": "out/a.png", "elapsed_ms": 12}

A `{"cmd": "shutdown"}` job stops the server; `{"cmd": "ping"}` reports
jobs_done and uptime.  Jobs are independent (keep-going semantics like
the CLI): a failed job reports {"ok": false, "error": ...} and the server
keeps serving; no job is carried on the CPU when the card fails.  Each job
is the port's cli.run_one on the server's device; handler threads share
the card.  Script files are cached by (path, mtime).

    python -m paintfe_tpu_torch.server --port 7878 --device cuda
"""

from __future__ import annotations

import json
import pathlib
import socket
import socketserver
import sys
import threading
import time
from typing import Optional


class _ScriptCache:
    """Script sources keyed by (path, mtime): stale entries for a PATH are
    evicted when its file changes; other paths keep their entries (two
    alternating scripts must both stay warm).  Locked — the TCP server
    handles jobs on concurrent threads, and an unlocked clear() between
    another thread's insert and read raised KeyError on valid jobs."""

    def __init__(self, max_entries: int = 64):
        self._cache = {}
        self._max = max_entries
        self._lock = threading.Lock()

    def get(self, path: str) -> str:
        p = pathlib.Path(path)
        key = (str(p), p.stat().st_mtime_ns)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        text = p.read_text()
        with self._lock:
            for k in [k for k in self._cache if k[0] == key[0]]:
                del self._cache[k]  # stale mtimes of the same path
            while len(self._cache) >= self._max:
                del self._cache[next(iter(self._cache))]
            self._cache[key] = text
            return text


class PaintServer:
    """Job executor with warm caches on `device` (the card unless the
    caller passes "cpu"; CUDA with no card raises); transport-agnostic."""

    def __init__(self, device="cuda"):
        from paintfe_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.scripts = _ScriptCache()
        self.jobs_done = 0
        self._jobs_lock = threading.Lock()  # handler threads are concurrent
        self.started = time.time()

    def handle(self, job: dict) -> dict:
        cmd = job.get("cmd")
        if cmd == "ping":
            return {
                "ok": True,
                "jobs_done": self.jobs_done,
                "uptime_s": round(time.time() - self.started, 3),
            }
        if cmd == "shutdown":
            return {"ok": True, "shutdown": True}
        t0 = time.time()
        try:
            out_path = self._run(job)
            with self._jobs_lock:
                self.jobs_done += 1
            return {
                "ok": True,
                "output": str(out_path),
                "elapsed_ms": int((time.time() - t0) * 1000),
            }
        except Exception as e:  # keep-going: report, don't die
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _run(self, job: dict) -> pathlib.Path:
        from paintfe_tpu_torch import cli

        input_path = pathlib.Path(job["input"])
        fmt = job.get("format", "png")
        output = job.get("output")
        out_path = (
            pathlib.Path(output) if output
            else cli.build_output_path(input_path, None, job.get("output_dir"), fmt)
        )
        out_path.parent.mkdir(parents=True, exist_ok=True)
        script_source = (
            self.scripts.get(job["script"]) if job.get("script") else None
        )
        cli.run_one(
            input_path, out_path, script_source, fmt,
            int(job.get("quality", 90)),
            not job.get("webp_lossy", False),
            job.get("tiff_compression", "none"),
            bool(job.get("flatten", True)),
            verbose=False, device=self.device,
        )
        return out_path


def serve_tcp(host: str = "127.0.0.1", port: int = 0, device="cuda"):
    """Start the TCP server on `device` (the card unless the caller passes
    "cpu"); returns (server, bound_port).  Each connection streams
    newline-delimited JSON jobs and gets one JSON reply per job, each
    connection on its own thread."""
    executor = PaintServer(device)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                line = raw.strip()
                if not line:
                    continue
                try:
                    job = json.loads(line)
                except json.JSONDecodeError as e:
                    reply = {"ok": False, "error": f"bad json: {e}"}
                else:
                    reply = executor.handle(job)
                self.wfile.write((json.dumps(reply) + "\n").encode())
                self.wfile.flush()
                if reply.get("shutdown"):
                    threading.Thread(target=self.server.shutdown,
                                     daemon=True).start()
                    return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    server = Server((host, port), Handler)
    server.executor = executor
    return server, server.server_address[1]


def request(port: int, job: dict, host: str = "127.0.0.1", timeout: float = 60.0) -> dict:
    """One job round-trip against a running server (client helper)."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(job) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="paintfe-tpu serving daemon (PyTorch + CUDA)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7878)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device the jobs run on (default cuda)")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    # build or load the kernel and native libraries before the first job: a
    # failed build stops the server here, never a job
    from paintfe_tpu_torch import native

    try:
        if args.device == "cuda":
            from paintfe_tpu_torch.utils.cuda_build import load_library

            load_library()
        native.load()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    server, port = serve_tcp(args.host, args.port, args.device)
    print(f"serving on {args.host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
