"""A kernel's share of its roofline in a traced window: the least time its
work could take on the card (``counts/<kernel>.py``), over its device time
in the trace, held to the program's launch counter."""
from __future__ import annotations

from benchmark.core import spec
from benchmark.counts.common import bound_ms


def share_pct(reading, kernel: str):
    cm = spec.module("counts", kernel)
    shape = reading.shapes.get(kernel)
    if shape is None:
        return None
    held = reading.held(cm.TAG, cm.COUNTER[1])
    if held is None:
        return None
    ms, n = held
    if n == 0 or ms <= 0:
        return None
    ops, nbytes = cm.work(shape)
    least, _ = bound_ms(nbytes, ops)
    return 100.0 * least * n / ms


def idle_pct(reading):
    if reading.window_s <= 0 or reading.busy_s <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)
