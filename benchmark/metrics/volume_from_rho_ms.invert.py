"""Device ms a step of the operations launched inside the program's
``invert.volume_from_rho`` span: the packed field rebuilt from rho in
PyTorch (three ``grad_axis`` stencils, a ``stack``, a ``permute`` and its
copy).  Left out where the window's ``invert.step`` spans are not as many
as its steps."""
from benchmark.core import spans


def read(reading):
    sr = spans.of(reading)
    n = spans.steps(sr, reading)
    if not n:
        return None
    s = sr.device_s("invert.volume_from_rho")
    return 1e3 * s / n if s > 0 else None
