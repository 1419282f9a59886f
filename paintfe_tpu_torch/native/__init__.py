"""The port's host-side C++: native/bytecodec.cpp's PNG defilter and TIFF
LZW encoder (the counterpart of the part of paintfe_tpu.native that builds
and binds those two functions).

g++ builds the source at first use into ``paintfe_tpu_torch/build/``
(git-ignored), under a name keyed by a hash of the source and flags, as
utils/cuda_build.py does for the kernels; a failed build raises with the
compiler's message.  ``-ffp-contract=off`` as in the JAX package (the code
is integer-only, so it changes nothing today).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = (_DIR / "bytecodec.cpp",)
BUILD_DIR = _DIR.parent / "build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off", "-std=c++17")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "png_defilter": ((_U8P, _U8P, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32),
                     ctypes.c_int),
    "tiff_lzw_encode": ((_U8P, ctypes.c_uint64, _U8P, ctypes.c_uint64), ctypes.c_int64),
}


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpfe_bytecodec_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises RuntimeError with
    g++'s message when the build fails."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".so.tmp{os.getpid()}")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed (rc {proc.returncode}) on "
                                   f"{' '.join(cmd)}:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
