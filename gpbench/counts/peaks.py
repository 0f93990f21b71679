"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates): HBM bytes/s and float32 FLOP/s outside the
tensor cores; and the least time a piece of work can take."""

HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate, in seconds."""
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOPS_S)
