"""Plain references: PyTorch ops that import nothing of the program.

Frozen copies of the port's plain versions, each with a float dtype `ft`:
float32 gives the program's exact u8 semantics, bfloat16 the control (the
nearest precision below the one the configurations state).
"""
