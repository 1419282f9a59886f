"""Effects of the port (paintfe_tpu.ops.effects counterparts)."""
