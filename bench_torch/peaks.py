"""Published peaks of the card, the yardstick of every roofline and mfu share.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit: HBM3
bandwidth and the float32 rate outside the tensor cores. TF32 is excluded: the
port keeps full float32 (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12}


def bound_s(flop: float, n_bytes: float, precision: str = "float32") -> float:
    """The least time the card could take: operations over the peak rate of the
    stated precision or bytes over HBM bandwidth, whichever is larger."""
    return max(flop / PEAK_FLOP_PER_S[precision], n_bytes / PEAK_BYTES_PER_S)
