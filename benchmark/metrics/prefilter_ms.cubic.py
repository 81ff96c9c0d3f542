"""Device ms a step of the operations launched inside the program's
``prefilter.coefficients`` span (K11, in the render's march) and its
``prefilter.transpose`` span (K12, in the backward).  Left out where the
window's ``invert.step`` spans are not as many as its steps, or the
program has no such spans."""
from benchmark.core import spans


def read(reading):
    sr = spans.of(reading)
    n = spans.steps(sr, reading)
    if not n:
        return None
    s = (sr.device_s("prefilter.coefficients")
         + sr.device_s("prefilter.transpose"))
    return 1e3 * s / n if s > 0 else None
