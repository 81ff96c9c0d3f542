"""The mean host us of a ``render.chunk`` span: one chunk of
``render_image_fast``'s loop, from its call to the return of its image
(its launches, and the host work between them).  Left out where the spans
are not as many as the program's chunk counter."""
from benchmark.core import spans


def read(reading):
    sr = spans.of(reading)
    if not spans.chunks_held(sr):
        return None
    return 1e6 * sr.host_s("render.chunk") / sr.chunks
