"""photon_tpu_torch — the PyTorch / CUDA port of photon_tpu.

A second package beside the JAX one, for one NVIDIA Hopper card.  Plain
tensor code is PyTorch; every kernel the JAX package wrote in Pallas has a
hand-written CUDA kernel under ``csrc/`` (built with ``nvcc`` at first
launch, see ``kernels.py``).  Module and function names follow
``photon_tpu`` so a reader finds the counterpart:

  config.py             parameter dataclasses, JSON / .mat round trip
  compat.py             from_reference(): numpy state of the JAX package ->
                        the port's objects on a device
  device.py             the device rule (the card unless the caller says cpu)
  kernels.py            nvcc build + ctypes loading of csrc/*.cu
  volume.py             DensityVolume, gradient precompute, NRRD ingest
  models/optics.py      camera / lens construction
  models/scenes.py      BOS dot-pattern source
  models/render.py      RenderParams
  models/render_fast.py render_image_fast: the (P, R) fast renderer
  ops/march_dense.py    plain dense chief-ray march
  ops/march_dense_fused.py  the march kernels' wrappers, forward and
                        backward (csrc/march_dense.cu, csrc/march_bwd.cu)
  ops/fan.py            fan statistics: kernel wrappers (csrc/fan_stats.cu)
                        + plain version
  ops/sensor_fast.py    particle_splat (anchors, sentinels, scale)
  ops/splat.py          the splat kernels' wrappers (csrc/splat.cu)
  inverse.py            volume_from_rho, invert_bos: Adam on a density grid
  postprocess.py        noise, gain, quantisation, crop
  pipeline.py           run_bos / run_simulation / save_result
  cli.py                batch command line

The slices so far: the BOS image pair through the fast renderer, its
gradient with respect to the density field, and the inversion built on it.
Nothing here imports ``jax`` or ``photon_tpu``.
"""

__version__ = "0.1.0"

from photon_tpu_torch.config import (  # noqa: F401
    SimulationConfig,
    LensDesign,
    CameraDesign,
    ParticleField,
    CalibrationGrid,
    BosPattern,
    DensityGradients,
    OutputData,
    default_config,
)
from photon_tpu_torch import inverse  # noqa: E402,F401
