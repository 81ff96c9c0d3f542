"""Device ms a step of the operations launched inside the program's
``invert.adam`` span: Adam's moments and rho's update over the grid.  Left
out where the window's ``invert.step`` spans are not as many as its
steps."""
from benchmark.core import spans


def read(reading):
    sr = spans.of(reading)
    n = spans.steps(sr, reading)
    if not n:
        return None
    s = sr.device_s("invert.adam")
    return 1e3 * s / n if s > 0 else None
