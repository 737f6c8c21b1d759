"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_FLOP_PER_S = 66.9e12    # float32 on the CUDA cores


def least_seconds(nbytes: float, flop: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S)
