"""The render's chunk loop (``render_image_fast``'s ``chunk_image``): no
kernel of its own, so no operations or bytes to count here.  Its spans,
``render.chunk``, are held to the program's counter
``render_image_fast.chunks`` (``core/spans.py``).

The traced window imports every file of ``counts/`` before it opens its
profiler session; importing this one attaches ``core/spans.py`` to that
session, so that the program's spans are read from it."""
from benchmark.core import spans

spans.attach()
