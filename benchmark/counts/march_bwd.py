"""K4, the march backward from the stage residual (``csrc/march_bwd.cu``,
``march_bwd_stage_kernel``), RK4 trilinear: the residual and the rays'
columns read, the touched voxels read once, the field's gradient written
once."""
from benchmark.counts.march_common import (MARCH_VJP_OPS_PER_COMBINE,
                                           MARCH_VJP_OPS_PER_STAGE)

TAG = "march_bwd_stage_kernel"
COUNTER = ("photon_tpu_torch.ops.march_dense_fused", "march_backward_stage")


def work(shape):
    P, steps = shape["rays"], shape["steps"]
    ops = steps * (4 * MARCH_VJP_OPS_PER_STAGE + MARCH_VJP_OPS_PER_COMBINE)
    nbytes = (steps * 20 * 4 + 21 * P * 4 + shape["touched"] * 16
              + shape["field_voxels"] * 16)
    return ops, nbytes
