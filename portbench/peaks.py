"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit), and the least time a piece of work can take."""

F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores, an FMA counted as two
HBM_BYTES_PER_S = 3.35e12


def least_s(ops: float, nbytes: float) -> float:
    """The larger of operations over the f32 peak and bytes over HBM's."""
    return max(ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
