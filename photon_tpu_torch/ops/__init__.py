"""Kernels' wrappers, their plain PyTorch versions, and the exact path's
operations."""
from photon_tpu_torch.ops.sensor import (  # noqa: F401
    diffraction_splat,
    bilinear_splat,
    sensor_coordinates,
    cos4_falloff,
)
