"""K12, the prefilter's transpose (``csrc/volume_prep.cu``,
``prefilter_tile_bwd_kernel``): the axes in reverse order, each launch a
third of one read of the coefficients' cotangent and one write of the
field's, as K11 (``counts/prefilter.py``)."""
from benchmark.counts.prefilter import AXES, OPS_PER_ELEMENT

TAG = "prefilter_tile_bwd_kernel"
COUNTER = ("photon_tpu_torch.native", "launch_prefilter_bwd")


def work(shape):
    elements = shape["voxels"] * shape["channels"]
    return OPS_PER_ELEMENT * elements, 2 * 4 * elements / AXES
