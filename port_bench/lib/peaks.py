"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit). A roofline share is stated against these, with the
card's power limit beside it."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores; TF32 is off in every configuration
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time a piece of work can take on the card: its operations
    at the FP32 peak or its bytes at the memory bandwidth, the larger."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
