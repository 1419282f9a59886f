from paintfe_tpu_torch.tools.brush import Brush, BrushMode  # noqa: F401
