"""Image IO of the port: its own copies of the JAX package's JAX-free
codec (codecs.py), GIF palette quantizer (neuquant.py) and Paint.NET
object-graph reader (nrbf.py), beside the .pfe container (pfe.py), the
.pdn import (pdn.py) and the 16-bit reader and writers (deep_export.py)."""
