"""The share of its roofline that the kernel of ``counts/prefilter_bwd.py`` reaches in
the traced window."""
from benchmark.core.roofline import share_pct


def read(reading):
    return share_pct(reading, "prefilter_bwd")
