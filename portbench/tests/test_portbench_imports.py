"""No module of the benchmark, and nothing a run loads, is JAX or the JAX
package (top-level names compared whole: paintfe_tpu_torch is the
program); the references import nothing of the program."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "paintfe_tpu"}


def _imported(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        assert not _imported(path) & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        assert "paintfe_tpu_torch" not in _imported(path), path
        assert not _imported(path) & FORBIDDEN, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "paintfe_tpu_torch_extra", sys)
    assert "paintfe_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "paintfe_tpu.core", sys)
    assert harness.forbidden_modules() == ["paintfe_tpu.core"]


_DRY = """
import json, sys, time, torch
from portbench import harness, run
for kind in ("entries", "metrics"):
    for p in sorted((harness.BENCH / kind).glob("*.py")):
        if p.stem != "__init__":
            harness.load_module(kind, p.stem)
r = harness.execute("cap16k-chain", 7, 0.05, False, [torch.device("cpu")], t0=time.perf_counter(),
                    overrides={"width": 64, "height": 48})
r2 = harness.execute("cap16k-flatten", 7, 0.05, False, [torch.device("cpu")],
                     t0=time.perf_counter(), overrides={"width": 32, "height": 24})
print(json.dumps([r["correct"], r2["correct"], sorted(sys.modules)]))
"""


def test_a_run_loads_no_jax():
    """A CPU run of two cells, in a process of its own, leaves no module of
    JAX or of the JAX package loaded."""
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", _DRY], capture_output=True, text=True, env=env,
                         cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ok_chain, ok_flatten, modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok_chain and ok_flatten
    assert "paintfe_tpu_torch" in modules
    assert not {m.split(".")[0] for m in modules} & FORBIDDEN


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, a run exits
    with an error and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "cap16k-chain",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
