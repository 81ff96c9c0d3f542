"""Device idle ms a request in the gaps of the window that began while the
host was inside a ``volume.*`` span (``build_density_volume``: the
stencil, and the minimum read back to the host).  Left out where the
window ran nothing on the card, or its ``volume.build`` spans are not one
a request."""
from benchmark.core import spans


def read(reading):
    sr = spans.of(reading)
    if sr is None or not sr.ops or not reading.requests:
        return None
    if sr.count("volume.build") != reading.requests:
        return None
    return 1e3 * sr.idle_from("volume.") / reading.requests
