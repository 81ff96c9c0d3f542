"""K1, the fused march forward (``csrc/march_dense.cu``), RK4 trilinear:
each ray's columns in and out, the voxels its samples touch read once, and
with the residual head each step's 20 floats written."""
from benchmark.counts.march_common import (MARCH_OPS_PER_RHS,
                                           MARCH_OPS_PER_RK4_COMBINE)

TAG = "march_dense_kernel"
COUNTER = ("photon_tpu_torch.ops.march_dense_fused", "march_chief_fused")


def work(shape):
    P, steps = shape["rays"], shape["steps"]
    ops = steps * (4 * MARCH_OPS_PER_RHS + MARCH_OPS_PER_RK4_COMBINE)
    if shape.get("residual"):
        nbytes = 15 * P * 4 + shape["touched"] * 16 + steps * 20 * 4
    else:
        nbytes = 12 * P * 4 + shape["touched"] * 16
    return ops, nbytes
