"""Published peaks of one H100 and the roofline bound.

Copied from ``chip_smoke.py``: the peaks and ``bound_ms``.  The peaks are
NVIDIA's data sheet for the SXM part, at its full 700 W."""
from __future__ import annotations

H100_F32_FLOPS = 67e12        # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3


def bound_ms(nbytes: float, ops: float):
    """Least time the card could take: bytes over the memory rate against
    operations over the f32 rate; returns (ms, which)."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
