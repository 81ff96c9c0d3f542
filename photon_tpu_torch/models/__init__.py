from photon_tpu_torch.models.optics import (  # noqa: F401
    CameraSetup, ElementStack, camera_setup, flatten_assembly,
    lensmaker_refractive_index)
