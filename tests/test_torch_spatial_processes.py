"""The port's spatial sharding over a mesh that spans processes
(paintfe_tpu_torch.parallel.spatial on a global mesh) against the JAX
package's spatial functions on conftest's eight CPU devices, tolerance 0.

One pair of gloo processes (PAINTFE_COORDINATOR / PAINTFE_NUM_PROCESSES /
PAINTFE_PROCESS_ID), each with four CPU entries of an 8-entry global rows
mesh, runs every spatial call on the same whole inputs (the JAX contract:
device_put of one host value onto a global sharding).  Process 0 owns the
mesh's first entry and writes the whole result; process 1 must return
None.  Each process also reports the kernel calls it made (on the CPU a
wrapper takes its plain version, so calls are counted, not launches), the
halo copies and the bytes it sent and received over gloo.  The pair ends
with a call whose shapes differ between the processes, which must raise
in both.

The workers import only the port (no JAX).  tests/test_torch_spatial.py
checks the plan of the halos across the process boundary in one process.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from paintfe_tpu.ops import filters as jfilters
from paintfe_tpu.parallel import spatial as jspatial
from paintfe_tpu.parallel.pipeline import _bc_device as j_bc, _sepia_device as j_sepia
from paintfe_tpu_torch.ops import filters as tfilters

REPO = pathlib.Path(__file__).resolve().parent.parent
MODES = (0, 8, 16, 3, 21)
OPACITIES = (1.0, 0.8, 0.5, 0.9, 0.7)


def _radius(sigma):
    return len(tfilters.gaussian_kernel(float(sigma))) // 2


def _swirl(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return xx + 3.0 * np.sin(yy / 9.0) - 1.5, yy + 2.0 * np.cos(xx / 7.0) + 0.75


def _inputs():
    rng = np.random.default_rng(151)

    def noise(*shape):
        return rng.integers(0, 256, shape + (4,), np.uint8)

    sx, sy = _swirl(61, 50)
    return {"img64": noise(64, 80), "ov64": noise(64, 80), "img61": noise(61, 80),
            "ov61": noise(61, 80), "med64": noise(64, 40), "med61": noise(61, 40),
            "src": noise(61, 50), "sx": sx, "sy": sy, "layers": noise(5, 61, 40),
            "blur": noise(96, 64), "bcs": noise(61, 40), "imgs": noise(4, 64, 24),
            "ovs": noise(4, 64, 24), "tiny": noise(20, 40), "tiny_ov": noise(20, 40)}


# Each call: (the port's call in the worker; the kernel it runs; its calls
# in each process, or None for the single-device route, one call on the
# owner; the block shape process 1 sends to process 0; the halo radius)
R2, R3, R15 = _radius(2.0), _radius(3.0), _radius(1.5)
CALLS = {
    "fused_chain_spatial 64x80": (
        "spatial.fused_chain_spatial(x['img64'], x['ov64'], rows)",
        "fused_chain_kernel", 4, (8, 80, 4), R2),
    "fused_chain_spatial 61x80": (
        "spatial.fused_chain_spatial(x['img61'], x['ov61'], rows)",
        "fused_chain_kernel", 4, (8, 80, 4), R2),
    "fused_chain_spatial sigma=0": (
        "spatial.fused_chain_spatial(x['img64'], x['ov64'], rows, sigma=0.0)",
        "fused_chain_kernel", 4, (8, 80, 4), 0),
    "median_spatial r=2 64x40": (
        "spatial.median_spatial(x['med64'], 2, rows)", "median_kernel", 4, (8, 40, 4), 2),
    "median_spatial r=2 61x40": (
        "spatial.median_spatial(x['med61'], 2, rows)", "median_kernel", 4, (8, 40, 4), 2),
    "median_spatial on rows_mesh()": (
        "spatial.median_spatial(x['med64'], 2)", "median_kernel", 4, (8, 40, 4), 2),
    "warp_spatial zero": (
        "spatial.warp_spatial(x['src'], x['sx'], x['sy'], 'zero', rows)",
        "gather_bilinear_u8", 4, (8, 50, 4), 0),
    "warp_spatial clamp": (
        "spatial.warp_spatial(x['src'], x['sx'], x['sy'], 'clamp', rows)",
        "gather_bilinear_u8", 4, (8, 50, 4), 0),
    "composite_spatial": (
        "spatial.composite_spatial(x['layers'], MODES, OPACITIES, rows)",
        "composite_stack_kernel", 4, (8, 40, 4), 0),
    "process_spatial blur sigma=3": (
        "spatial.process_spatial(x['blur'], lambda t: tfilters.gaussian_blur(t, 3.0), rows, "
        "halo=R3)", "gaussian_blur_fused", 4, (12, 64, 4), R3),
    "process_spatial blur-bc-sepia": (
        "spatial.process_spatial(x['bcs'], bcs, rows, halo=R15)", "gaussian_blur_fused", 4,
        (8, 40, 4), R15),
    "fused_chain_grid 2x4": (
        "spatial.fused_chain_grid(x['imgs'], x['ovs'], spatial.grid_mesh(2, 4, g))",
        "fused_chain_kernel", 2 * 4, (2, 16, 24, 4), R2),
    "fused_chain_grid 1x8": (
        "spatial.fused_chain_grid(x['imgs'], x['ovs'], spatial.grid_mesh(1, 8, g))",
        "fused_chain_kernel", 4 * 4, (4, 8, 24, 4), R2),  # 4 images an entry
    "single-device route": (
        "spatial.fused_chain_spatial(x['tiny'], x['tiny_ov'], rows)",
        "fused_chain_kernel", None, None, R2),
}

WORKER = """
import json, pathlib, sys
import numpy as np, torch
import torch.distributed as dist
from paintfe_tpu_torch.parallel import distributed
assert distributed.maybe_initialize()
from paintfe_tpu_torch.core import composite as tcomp
from paintfe_tpu_torch.ops import filters as tfilters, fused_chain as tchain
from paintfe_tpu_torch.ops import kernels as tkernels, warp_kernel as twarp
from paintfe_tpu_torch.parallel import mesh as tmesh, pipeline as tpipe, spatial

me, cpu = distributed.rank(), torch.device("cpu")
tmesh._local_cards = lambda: [cpu] * 4  # each process's four entries
calls, halos, p2p = {}, [], []

def counted(module, name):
    fn = getattr(module, name)
    def call(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)
    setattr(module, name, call)
    return call

counted(tchain, "fused_chain_kernel")
counted(tkernels, "median_kernel")
counted(twarp, "gather_bilinear_u8")
counted(tkernels, "gaussian_blur_fused")
tcomp.composite_stack_kernel = counted(tkernels, "composite_stack_kernel")

inner = spatial._halo_extend
def halo(block, r, up, down, axis=0):
    halos.append([(up is not None) + (down is not None), r, block[0].numel() if axis == 0
                  else block[:, 0].numel()])
    return inner(block, r, up, down, axis)
spatial._halo_extend = halo

for op in ("isend", "irecv", "send", "recv"):
    def wrapped(t, *a, _op=op, _fn=getattr(dist, op), **k):
        p2p.append([_op, t.numel() * t.element_size(), list(t.shape)])
        return _fn(t, *a, **k)
    setattr(dist, op, wrapped)

x = dict(np.load("inputs.npz"))
MODES, OPACITIES, R3, R15 = %(consts)s
def bcs(t):
    return tpipe._sepia_device(tpipe._bc_device(tfilters.gaussian_blur(t, 1.5), 10.0, 20.0), 0.5)

g = distributed.global_batch_mesh([cpu] * 4)
rows = spatial.rows_mesh(g)
report = {"rows": rows.process_indices.tolist(),
          "default": spatial.rows_mesh().process_indices.tolist(),
          "grids": [spatial.grid_mesh(2, 4, g).process_indices.tolist(),
                    spatial.grid_mesh(1, 8, g).process_indices.tolist()]}
for name, code in %(calls)s.items():
    calls.clear(); halos.clear(); p2p.clear()
    out = eval(code)
    report[name] = {"none": out is None, "calls": dict(calls), "halos": list(halos),
                    "p2p": list(p2p)}
    if out is not None:
        np.save(f"p{me}_{name}.npy", out.numpy())
assert "jax" not in sys.modules and "paintfe_tpu" not in sys.modules
json.dump(report, open(f"report{me}.json", "w"))
print("WORKER-DONE", me, flush=True)
# the same call with one row fewer in process 1: both processes must raise
spatial.median_spatial(x["med64"][:64 - me], 2, rows)
print("MISMATCH-PASSED", me, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The one pair of processes: their exit codes and output, each one's
    report, process 0's results, and the inputs."""
    tmp = tmp_path_factory.mktemp("spatial_processes")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    code = WORKER % {"calls": repr({k: v[0] for k, v in CALLS.items()}),
                     "consts": repr((MODES, OPACITIES, R3, R15))}
    port = _free_port()
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, PAINTFE_COORDINATOR=f"localhost:{port}",
                   PAINTFE_NUM_PROCESSES="2", PAINTFE_PROCESS_ID=str(pid))
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            p.kill()
    for pid, (_, out) in enumerate(outs):
        assert f"WORKER-DONE {pid}" in out, out[-4000:]
    reports = [json.loads((tmp / f"report{pid}.json").read_text()) for pid in (0, 1)]
    return {"outs": outs, "reports": reports, "dir": tmp, "inputs": inputs}


def _jmesh8():
    return jspatial.rows_mesh(jax.devices()[:8])


def _jax(name, x):
    """The JAX function of each call, on the 8 CPU devices."""
    grid = {"fused_chain_grid 2x4": (2, 4), "fused_chain_grid 1x8": (1, 8)}
    if name in grid:
        mesh = jspatial.grid_mesh(*grid[name], jax.devices()[:8])
        return jspatial.fused_chain_grid(x["imgs"], x["ovs"], mesh)
    m = _jmesh8()
    if name.startswith("fused_chain_spatial"):
        img, ov = (x["img64"], x["ov64"]) if "61" not in name else (x["img61"], x["ov61"])
        return jspatial.fused_chain_spatial(img, ov, m, **({"sigma": 0.0} if "sigma" in name
                                                            else {}))
    if name == "single-device route":
        return jspatial.fused_chain_spatial(x["tiny"], x["tiny_ov"], m)
    if name.startswith("median_spatial"):
        return jspatial.median_spatial(x["med61"] if "61" in name else x["med64"], 2, m)
    if name.startswith("warp_spatial"):
        return jspatial.warp_spatial(x["src"], x["sx"], x["sy"], mode=name.split()[-1],
                                     mesh=m)
    if name == "composite_spatial":
        return jspatial.composite_spatial(x["layers"], MODES, np.float32(OPACITIES), m)
    if name == "process_spatial blur sigma=3":
        return jspatial.process_spatial(x["blur"], lambda t: jfilters.gaussian_blur(t, 3.0), m)
    assert name == "process_spatial blur-bc-sepia"
    return jspatial.process_spatial(
        x["bcs"], lambda t: j_sepia(j_bc(jfilters.gaussian_blur(t, 1.5), 10.0, 20.0), 0.5), m)


@pytest.mark.parametrize("name", list(CALLS))
def test_owner_result_equals_the_jax_function(pair, name):
    """Process 0 (the owner of the mesh's first entry) returns the whole
    result, equal to the JAX function on 8 CPU devices, tolerance 0;
    process 1 returns None."""
    zero, one = (r[name] for r in pair["reports"])
    assert not zero["none"] and one["none"]
    got = np.load(pair["dir"] / f"p0_{name}.npy")
    np.testing.assert_array_equal(got, np.asarray(_jax(name, pair["inputs"])))


@pytest.mark.parametrize("name", list(CALLS))
def test_each_process_runs_its_own_entries(pair, name):
    """One kernel call an owned entry (an image an entry on the grid);
    the single-device route runs once, on the owner alone."""
    _, kernel, per_process, _, _ = CALLS[name]
    zero, one = (r[name]["calls"] for r in pair["reports"])
    if per_process is None:
        assert zero == {kernel: 1} and one == {}
    else:
        assert zero == one == {kernel: per_process}


@pytest.mark.parametrize("name", list(CALLS))
def test_only_the_gather_crosses_processes(pair, name):
    """The only point-to-point messages are the gather's: process 1 sends
    each of its four blocks' results once (isend), process 0 receives
    each once (irecv) and sends nothing; the single-device route sends
    nothing.  Each process copies its blocks' halos, 2 (n - 1) copies of
    r rows in all, whatever side of the process boundary."""
    _, _, _, shape, r = CALLS[name]
    zero, one = (rep[name] for rep in pair["reports"])
    if shape is None:
        assert zero["p2p"] == one["p2p"] == [] and zero["halos"] == one["halos"] == []
        return
    nbytes = int(np.prod(shape))
    assert one["p2p"] == [["isend", nbytes, list(shape)]] * 4
    assert zero["p2p"] == [["irecv", nbytes, list(shape)]] * 4
    copies = [[c for c, *_ in p["halos"]] for p in (zero, one)]
    if r == 0:
        assert copies == [[], []]
    elif name == "fused_chain_grid 2x4":  # one 'batch' row a process: 1 + 2 + 2 + 1
        assert copies == [[1, 2, 2, 1], [1, 2, 2, 1]]
    else:  # entries 0..3 and 4..7 of the rows: the boundary's two copies cross
        assert copies == [[1, 2, 2, 2], [2, 2, 2, 1]]
    row = int(np.prod(shape)) // shape[-3]  # bytes of one row of a block (a slab's row)
    assert all(hr == r and n == row for p in (zero, one) for _, hr, n in p["halos"])


def test_meshes_span_the_job(pair):
    """rows_mesh over global_batch_mesh keeps each entry's process;
    rows_mesh() with no devices spans every process's cards in rank order;
    grid_mesh(2, 4) gives each process one 'batch' row, grid_mesh(1, 8)
    splits the rows across both."""
    for report in pair["reports"]:
        assert report["rows"] == report["default"] == [0] * 4 + [1] * 4
        assert report["grids"] == [[[0] * 4, [1] * 4], [[0] * 4 + [1] * 4]]


def test_mismatched_call_raises_in_both(pair):
    """A call whose shapes differ between the processes raises in both,
    before any rows move: exit code 1 and the message, no hang."""
    for rc, out in pair["outs"]:
        assert rc == 1, out[-4000:]
        assert "spatial: the processes disagree on the call" in out
        assert "MISMATCH-PASSED" not in out
