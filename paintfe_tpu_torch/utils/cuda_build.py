"""Build and load the port's CUDA kernels (``paintfe_tpu_torch/csrc``).

nvcc compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process per
source, all started together, and links the objects into one shared
library with a plain C interface, loaded with ctypes.  The build runs at
first use, into ``paintfe_tpu_torch/build/`` (git-ignored), under a name
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the library already built.

The flags keep f32 math IEEE: ``-fmad=false`` stops nvcc from contracting
a multiply and an add into an FMA (the kernels must reproduce the JAX
package's separately rounded sums), and there is no ``--use_fast_math``, so
division and sqrtf stay correctly rounded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from paintfe_tpu_torch.utils import profiling

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points: name -> argtypes; each returns cudaGetLastError() as int.
_SIGNATURES = {
    "pfe_blur_tiled": (_P, _P, _I, _I, _I, _P, _I, _I, _I, _P),
    "pfe_blur_split": (_P, _P, _P, _I, _I, _I, _P, _I, _P),
    "pfe_chain_tiled": (_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P),
    "pfe_chain_tail": (_P, _P, _P, _I, _I, _P, _P, _P),
    "pfe_chain_div_check": (ctypes.c_float, _P, _P),
    "pfe_median": (_P, _P, _I, _I, _I, _I, _I, _P),
    "pfe_warp_bilinear": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "pfe_composite": (_P, _P, _P, _P, _I, _P, _P, _L, _P),
    "pfe_composite_div_check": (_I, ctypes.c_float, _P, _P),
    "pfe_blur_pass": (_P, _P, _P, _L, _I, _I, _I, _P),
}

# What load_library() did in this process: its seconds (nvcc's build
# included when the library was not built yet), the library, nvcc's log and,
# after a build, each source's compile seconds.
BUILD_INFO = {"seconds": None, "log": None, "library": None, "sources": {}}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpfe_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd):
    """Run one command; (cmd, stdout, stderr, returncode, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return cmd, proc.stdout, proc.stderr, proc.returncode, time.perf_counter() - t0


def _run_all(cmds):
    """Run the commands at once, each timed on its own."""
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        return list(pool.map(_run, cmds))


# One build at a time in a process: the objects are named by the process,
# and the server's handler threads may ask at once.
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    with _BUILD_LOCK:
        return _build_and_load()


def _build_and_load() -> ctypes.CDLL:
    so = library_path()
    log = so.with_suffix(".log")
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu, _ = _sources()
        nvcc = _nvcc()
        stem = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in cu]
        tmp = BUILD_DIR / f"{stem}.tmp.so"
        # one nvcc per source, all started together: the build takes as
        # long as the slowest source, not the sum
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                            for src, obj in zip(cu, objs)])
        if all(rc == 0 for *_, rc, _ in results):
            results += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        log.write_text("".join(f"{' '.join(cmd)}\n{out}{err}"
                               for cmd, out, err, *_ in results))
        BUILD_INFO["sources"] = {pathlib.Path(cmd[-1]).name: seconds
                                 for cmd, *_, seconds in results[:len(cu)]}
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, _, err, rc, _ in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed (rc {rc}) on {cmd[-1]}:\n"
                                   f"{err[-4000:]}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(so),
                      log=str(log) if log.exists() else None)
    return lib


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {rc}")


# The lock of every count (utils/profiling.COUNT_LOCK): `fn.launches += 1`
# is a read, an add and a write, and the server's handler threads launch
# at once.
LAUNCH_LOCK = profiling.COUNT_LOCK
# Add one to `wrapper.launches`, the count a kernel's wrapper keeps of its
# launches; read a consistent set of counts under LAUNCH_LOCK.
count_launch = profiling.count_launch


def launch_counts() -> dict:
    """The launch count of each kernel that has launched in this process,
    by wrapper name (a CPU run launches none)."""
    n = len(profiling.LAUNCHES)
    return {name[n:]: c for name, c in profiling.counts().items()
            if name.startswith(profiling.LAUNCHES)}
