"""Image IO of the port: its own copies of the JAX package's JAX-free
codec (codecs.py) and GIF palette quantizer (neuquant.py)."""
