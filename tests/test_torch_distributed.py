"""The port's multi-process layer (paintfe_tpu_torch.parallel.distributed)
against tests/test_distributed.py: two real processes joined by
PAINTFE_COORDINATOR / PAINTFE_NUM_PROCESSES / PAINTFE_PROCESS_ID over
gloo, each with --device cpu and four local mesh entries (torch has one
CPU device, so the entries repeat it, where the JAX tests force four host
devices a process); the two-process CLI's files equal the JAX CLI's
--shard output byte for byte.  Also: partial wiring, and run_batch over
1-, 2- and 3-entry CPU meshes against the JAX run_batch (tolerance 0).

Each test spawns fresh Python processes: a process joins one process
group, and the workers import only the port (no JAX).
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from paintfe_tpu import cli as jcli
from paintfe_tpu.parallel import pipeline as jpipe
from paintfe_tpu_torch import cli as tcli
from paintfe_tpu_torch.parallel import distributed, pipeline as tpipe
from paintfe_tpu_torch.parallel.mesh import Mesh

REPO = pathlib.Path(__file__).resolve().parent.parent
WIRING = ("PAINTFE_COORDINATOR", "PAINTFE_NUM_PROCESSES", "PAINTFE_PROCESS_ID")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(code: str, pid: int, nproc: int, port: int, tmp: pathlib.Path):
    env = dict(os.environ)
    env["PAINTFE_COORDINATOR"] = f"localhost:{port}"
    env["PAINTFE_NUM_PROCESSES"] = str(nproc)
    env["PAINTFE_PROCESS_ID"] = str(pid)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", code], env=env, cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _run_pair(code: str, tmp: pathlib.Path, timeout=120):
    port = _free_port()
    procs = [_spawn(code, pid, 2, port, tmp) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            p.kill()
    return outs


WORKER_PRELUDE = """
import sys, torch
from paintfe_tpu_torch.parallel import distributed
assert distributed.maybe_initialize()
assert distributed.maybe_initialize()  # a second call: already joined
assert "jax" not in sys.modules and "paintfe_tpu" not in sys.modules
"""


def test_two_process_mesh_and_collective(tmp_path):
    code = WORKER_PRELUDE + """
import torch.distributed as dist
assert distributed.world_size() == 2
local = [torch.device("cpu")] * 4

# 2-D DCN x ICI mesh shape and axis placement
m = distributed.slice_mesh(local)
assert m.devices.shape == (2, 4)
assert m.axis_names == ("dcn", "ici")
# every entry in row p belongs to process p
for p in range(2):
    assert all(int(i) == p for i in m.process_indices[p])
g = distributed.global_batch_mesh(local)
assert g.shape == {"batch": 8}
assert list(g.process_indices) == [0] * 4 + [1] * 4

# deterministic round-robin input sharding, disjoint + covering
mine = distributed.shard_inputs(list(range(10)))
assert mine == list(range(distributed.rank(), 10, 2))

# a real cross-process collective: a sum over the global mesh's entries
x = torch.ones(2) * sum(int(i) == distributed.rank() for i in g.process_indices)
dist.all_reduce(x)
assert float(x[0]) == 8.0

# exit-code agreement: process 1 reports failure, both must see it
ok = distributed.all_processes_ok(distributed.rank() != 1)
assert ok is False
assert distributed.all_processes_ok(True) is True
print("WORKER-OK", distributed.rank())
"""
    outs = _run_pair(code, tmp_path)
    for rc, out in outs:
        assert rc == 0, out
        assert "WORKER-OK" in out


CLI_WORKER = WORKER_PRELUDE + """
from paintfe_tpu_torch import cli
rc = cli.main(sys.argv[1:] or {argv!r})
print("CLI-RC", rc)
sys.exit(rc)
"""


def test_two_process_cli_shard(tmp_path, monkeypatch):
    # four distinct tiny inputs; both processes run the same CLI invocation
    # and split the work between them
    from PIL import Image

    for i in range(4):
        a = np.random.default_rng(i).integers(0, 256, (16, 16 + 4 * (i % 2), 4), np.uint8)
        a[0, 0, 0] = 40 * (i + 1)
        a[..., 3] = 255
        Image.fromarray(a, "RGBA").save(tmp_path / f"in{i}.png")
    (tmp_path / "fx.rhai").write_text("apply_invert(); apply_blur(1.5);\n")
    common = ["-i", "in*.png", "-s", "fx.rhai", "--shard", "-f", "png", "-v"]
    argv = common + ["--device", "cpu"]
    outs = _run_pair(CLI_WORKER.format(argv=argv + ["--output-dir", "out"]), tmp_path)
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, out
        assert f"[distributed] process {pid} handles 2 input(s)" in out
        # the CPU route launches no kernel, and the report says so
        assert f"[distributed] process {pid} kernel launches: {{}}" in out

    # every file equals the JAX CLI's --shard output on the same inputs and
    # script, and the port's single-process --shard run's, byte for byte
    monkeypatch.chdir(tmp_path)
    assert jcli.main(common + ["--output-dir", "jax"]) == 0
    assert tcli.main(argv + ["--output-dir", "one"]) == 0
    for i in range(4):
        p = tmp_path / "out" / f"in{i}.png"
        assert p.exists(), f"missing output for input {i}"
        assert p.read_bytes() == (tmp_path / "jax" / f"in{i}.png").read_bytes(), i
        assert p.read_bytes() == (tmp_path / "one" / f"in{i}.png").read_bytes(), i


def test_two_process_cli_shard_keep_going_exit_code(tmp_path):
    # one process hits a decode failure -> BOTH processes must exit 1
    from PIL import Image

    for i in range(4):
        a = np.full((8, 8, 4), 10 * i, np.uint8)
        Image.fromarray(a, "RGBA").save(tmp_path / f"in{i}.png")
    # corrupt one file (round-robin sends in1/in3 to process 1)
    (tmp_path / "in1.png").write_bytes(b"not a png at all")
    argv = ["-i", "in*.png", "--shard", "--output-dir", "out", "-f", "png",
            "--device", "cpu"]
    outs = _run_pair(CLI_WORKER.format(argv=argv), tmp_path)
    for rc, out in outs:
        assert rc == 1, out
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        ["in0.png", "in2.png", "in3.png"]


@pytest.mark.parametrize("present", [(0,), (1,), (2,), (0, 1), (0, 2), (1, 2)])
def test_partial_wiring_raises_and_the_cli_exits_1(present, monkeypatch, capsys, tmp_path):
    """Partial wiring is a launcher bug: maybe_initialize names what is
    missing, and the CLI exits 1 with that message, writing nothing."""
    for k, name in enumerate(WIRING):
        if k in present:
            monkeypatch.setenv(name, {0: "localhost:1", 1: "2", 2: "0"}[k])
        else:
            monkeypatch.delenv(name, raising=False)
    missing = ", ".join(n for k, n in enumerate(WIRING) if k not in present)
    with pytest.raises(RuntimeError, match=f"partial multi-process wiring: missing {missing}$"):
        distributed.maybe_initialize()
    from PIL import Image

    Image.fromarray(np.zeros((4, 4, 4), np.uint8), "RGBA").save(tmp_path / "a.png")
    assert tcli.main(["-i", str(tmp_path / "a.png"), "--output-dir", str(tmp_path / "o"),
                      "--device", "cpu"] + (["--shard"] if 0 not in present else [])) == 1
    assert f"partial multi-process wiring: missing {missing}" in capsys.readouterr().err
    assert not (tmp_path / "o" / "a.png").exists()


def test_no_wiring_is_a_single_process(monkeypatch):
    for name in WIRING:
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize() is False
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.shard_inputs([1, 2, 3]) == [1, 2, 3]
    assert distributed.shard_inputs(list(range(7)), 1, 3) == [1, 4]
    assert distributed.all_processes_ok(True) and not distributed.all_processes_ok(False)
    m = distributed.global_batch_mesh(["cpu"] * 3)
    assert m.shape == {"batch": 3} and list(m.process_indices) == [0, 0, 0]


_OPS = "apply_blur(1.5); apply_noise(12.0, true); apply_median(1); apply_sepia(0.5);"


@pytest.mark.parametrize("n", [1, 2, 3])
def test_run_batch_over_cpu_meshes_matches_jax(n):
    """N = 4 (5 for n = 2) frames over an n-entry CPU mesh: padded with zero
    frames to a multiple of n, one slice an entry, gathered in order; equal
    to the JAX run_batch on its 8-device mesh."""
    rng = np.random.default_rng(n)
    images = rng.integers(0, 256, (5 if n == 2 else 4, 24, 20, 4), np.uint8)
    ref = jpipe.run_batch(images, jpipe.trace_script(_OPS))
    out = tpipe.run_batch(images, tpipe.trace_script(_OPS), Mesh(["cpu"] * n, ("batch",)))
    assert out.shape == images.shape
    np.testing.assert_array_equal(out, ref)
