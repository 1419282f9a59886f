"""paintfe_tpu_torch — the PyTorch + CUDA port of paintfe_tpu.

Same module names and public layouts as the JAX package (u8 images
[H, W, 4], batches [B, H, W, 4]); plain tensor code is PyTorch, and the
Pallas kernels on the ported path are hand-written CUDA C++ for Hopper
(``csrc/``), built at first use.  Importing this package never imports
JAX.
"""

__version__ = "0.1.0"
