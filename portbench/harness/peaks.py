"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, at 700 W) and
the least time a piece of work can take on it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S) -> float:
    """max(bytes / bandwidth, operations / peak): each input read once, each
    output written once."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)
