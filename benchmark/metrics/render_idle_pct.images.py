"""The share of the host's time inside ``render.image`` spans (one call of
``render_image_fast``) in which the card ran nothing.  Left out where the
window ran nothing on the card, or its ``render.chunk`` spans are not as
many as the program's chunk counter."""
from benchmark.core import spans


def read(reading):
    sr = spans.of(reading)
    if not spans.chunks_held(sr) or not sr.ops:
        return None
    idle, total = sr.idle_inside("render.image")
    return 100.0 * idle / total if total > 0 else None
