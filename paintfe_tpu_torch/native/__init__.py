"""The port's host-side C++ (the counterpart of paintfe_tpu.native):
bytecodec.cpp's PNG defilter and TIFF LZW encoder and decoder, ljpeg.cpp's
lossless-JPEG (SOF3) and jpegdct.cpp's baseline-DCT decoders for RAW
containers (io/raw.py), neuquant.cpp's GIF palette trainer
(io/neuquant.py), and inpaint.cpp's Content-Aware Fill: PatchMatch and the
instant brush (ops/inpaint.py).

g++ builds the sources at first use, into one library, into
``paintfe_tpu_torch/build/`` (git-ignored), under a name keyed by a hash of the
sources and flags, as
utils/cuda_build.py does for the kernels; a failed build raises with the
compiler's message: no caller falls back to Python when the build fails.
``-ffp-contract=off`` as in the JAX package: NeuQuant's f64 updates, the
DCT's float IDCT and the inpainting's f32 sums must not fuse a multiply
and an add.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import threading

_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = tuple(_DIR / name for name in (
    "bytecodec.cpp", "ljpeg.cpp", "jpegdct.cpp", "neuquant.cpp", "inpaint.cpp"))
BUILD_DIR = _DIR.parent / "build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off", "-std=c++17")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U32, _U64 = ctypes.c_uint32, ctypes.c_uint64
_SIGNATURES = {
    "png_defilter": ((_U8P, _U8P, _U32, _U32, _U32), ctypes.c_int),
    "tiff_lzw_encode": ((_U8P, _U64, _U8P, _U64), ctypes.c_int64),
    "tiff_lzw_decode": ((_U8P, _U64, ctypes.c_int64, ctypes.POINTER(_U8P)), ctypes.c_int64),
    "pfe_free": ((ctypes.c_void_p,), None),
    "ljpeg_info": ((_U8P, _U32, _U32P), ctypes.c_int),
    "ljpeg_decode": ((_U8P, _U32, _U16P, _U64), ctypes.c_int),
    "jpegdct_info": ((_U8P, _U32, _U32P), ctypes.c_int),
    "jpegdct_decode": ((_U8P, _U32, _U8P, _U64), ctypes.c_int),
    "neuquant_quantize": ((_U8P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _U8P, _U8P),
                          ctypes.c_int),
    "patchmatch_fill": ((_U8P, _U8P, _U8P, _U32, _U32, _U32, _U32), None),
    "inpaint_instant_brush": ((_U8P, _U8P, _U8P, _U32, _U32, ctypes.c_float,
                               ctypes.c_float, ctypes.c_float, ctypes.c_float,
                               ctypes.c_float), None),
}


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpfe_native_{h.hexdigest()[:16]}.so"


# One build at a time in a process: the temporary file is named by the
# process, and the server's handler threads may ask at once.
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises RuntimeError with
    g++'s message when the build fails."""
    with _BUILD_LOCK:
        return _build_and_load()


def _build_and_load() -> ctypes.CDLL:
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
