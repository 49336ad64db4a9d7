"""Published peaks of one NVIDIA H100 SXM5 (NVIDIA's data sheet: float32
outside the tensor cores, HBM3 bandwidth), at its 700 W limit."""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
