"""The share of the traced window in which no operation ran on the card
(the profiler's device records, their union over the window)."""
from benchmark.core.roofline import idle_pct


def read(reading):
    return idle_pct(reading)
