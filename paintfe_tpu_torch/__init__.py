"""paintfe_tpu_torch — the PyTorch + CUDA port of paintfe_tpu.

Same module names and public layouts as the JAX package (u8 images
[H, W, 4], batches [B, H, W, 4]); plain tensor code is PyTorch, and the
Pallas kernels on the ported path are hand-written CUDA C++ for Hopper
(``csrc/``), built at first use.  Importing this package never imports
JAX, nor torch or a kernel until an export is first read.
"""

__version__ = "0.1.0"

# Lazy re-exports (PEP 562), as the JAX package: paintfe_tpu_torch.Project
# etc. import their modules at first use only.
_EXPORTS = {
    "BlendMode": ("paintfe_tpu_torch.core.blend", "BlendMode"),
    "Canvas": ("paintfe_tpu_torch.core.canvas", "Canvas"),
    "Layer": ("paintfe_tpu_torch.core.canvas", "Layer"),
    "Project": ("paintfe_tpu_torch.core.project", "Project"),
}


def __getattr__(name):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'paintfe_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
