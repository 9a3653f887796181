"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W power limit): HBM3 bytes a second, and float32 operations a second
outside the tensor cores, the rate used for every scalar operation, the
integer and float64 ones included (the card's rates for those are lower,
so a share of this peak reads low rather than high)."""

BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the scalar rate."""
    return max(nbytes / BYTES_PER_S, ops / OPS_PER_S)
