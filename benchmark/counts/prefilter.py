"""K11, the cubic B-spline prefilter (``csrc/volume_prep.cu``,
``prefilter_tile_kernel``): a call runs three launches, one an axis, that
together read the (D, H, W, C) field once and write its coefficients once
(the tiles hold whole lines in shared memory); a launch is charged a third
of that, and some 5 operations an element, far under the bytes' time.

The program's spans ``prefilter.coefficients`` and ``prefilter.transpose``
(``photon_tpu_torch.native``) are read beside those of ``core/spans.py``:
the traced window imports every file of ``counts/`` before it opens its
profiler session, and importing this one adds their prefix to the ones
``core/spans.py`` reads.  A program without these spans reads as before."""
from benchmark.core import spans

TAG = "prefilter_tile_kernel"
COUNTER = ("photon_tpu_torch.native", "launch_prefilter")
AXES = 3
OPS_PER_ELEMENT = 5


def read_spans() -> None:
    """Adds the prefix of the prefilter's spans to those that
    ``core/spans.py`` reads (once)."""
    if "prefilter." not in spans.PREFIXES:
        spans.PREFIXES = spans.PREFIXES + ("prefilter.",)


read_spans()


def work(shape):
    elements = shape["voxels"] * shape["channels"]
    return OPS_PER_ELEMENT * elements, 2 * 4 * elements / AXES
