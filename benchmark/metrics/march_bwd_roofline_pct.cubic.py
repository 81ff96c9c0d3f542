"""The share of its roofline that the kernel of ``counts/march_bwd_cubic.py`` reaches in
the traced window."""
from benchmark.core.roofline import share_pct


def read(reading):
    return share_pct(reading, "march_bwd_cubic")
