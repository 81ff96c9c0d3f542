"""Host ms of a finished solve's tail: its ``invert.result_volume`` span
(the result volume, K10) and its ``invert.rho_to_host`` span (rho copied
to the host), a solve.  Left out where the window holds no finished solve
or the two spans are not as many."""
from benchmark.core import spans


def read(reading):
    sr = spans.of(reading)
    if sr is None:
        return None
    n = sr.count("invert.result_volume")
    if not n or sr.count("invert.rho_to_host") != n:
        return None
    return 1e3 * (sr.host_s("invert.result_volume")
                  + sr.host_s("invert.rho_to_host")) / n
