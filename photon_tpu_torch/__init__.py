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
  volume.py             DensityVolume, NRRD ingest, the packed field's build
  native.py             the volume's preparation: the gradient precompute
                        and the B-spline prefilter and its transpose, plain
                        versions and kernels (csrc/volume_prep.cu), the
                        NRRD probe
  models/optics.py      camera / lens construction
  models/scenes.py      light-field sources: BOS dot patterns, PIV particle
                        fields (random, loaded, image-driven), calibration
                        grids
  models/render.py      RenderParams and the exact-semantics renderer
                        (render_image, render_rays, trace_chunk)
  models/render_fast.py render_image_fast: the (P, R) fast renderer, with
                        the per-ray chain where its fan kernel does not apply
  ops/lens.py           RayBundle; thin, thick (dispersion, absorbance) and
                        aperture propagation of any train (exact path)
  ops/interp.py         texture lookup, tex3D trilinear and tricubic
                        sampling (exact path)
  ops/march.py          the exact path's march: AABB entry, Euler, RK4,
                        adaptive RK45, Adams-Bashforth, grad-n noise, the
                        differentiable loop, the per-step recorder
  ops/sensor.py         erf diffraction and bilinear sensors (exact path)
  ops/march_dense.py    plain dense chief-ray march
  ops/march_dense_fused.py  the march kernels' wrappers, forward and
                        backward, the stagewise ones for Adams-Bashforth and
                        substeps (csrc/march_dense.cu, csrc/march_bwd.cu)
  ops/march_dense_sampler.py  the per-stage slab sampler's wrappers
                        (csrc/slab_sample.cu) and its plain version
  ops/march_fast.py     apply_chief_deltas: a march's deltas on a ray fan
  ops/fan.py            fan statistics: kernel wrappers (csrc/fan_stats.cu,
                        csrc/fan_stats_bwd.cu) + plain version, the per-ray
                        chain's ray path
  ops/mie.py            Mie scattering tables (host numpy)
  ops/sensor_fast.py    particle_splat and the per-ray deposits
  ops/splat.py          the splat kernels' wrappers (csrc/splat.cu)
  inverse.py            volume_from_rho, invert_bos: Adam on a density grid
  postprocess.py        noise, gain, quantisation, crop
  pipeline.py           run_bos / run_piv / run_cal / run_simulation /
                        save_result, routing each case to a renderer; the
                        ray dumps (save_lightrays)
  cli.py                batch command line
  parallel/             multi-device rendering over torch.distributed, one
                        process a device: make_mesh, multihost_init,
                        render_image_fast(mesh=...)'s two collectives, the
                        scaling harness (shard.py); the multi-device dry run
                        (dryrun.py)
  utils/                NRRD, TIFF and PNG I/O, GlibcRand, phase timers,
                        ray_statistics
  analysis/             ray-dump loading, per-dot BOS displacements, the
                        paraxial oracle, synthetic fields (numpy / scipy)

The slices so far: the BOS image pair through the fast renderer, its
gradient with respect to the density field and the inversion built on it,
the whole march menu on volumes of any size, PIV with Mie scattering and
calibration grids, the per-ray chain (rotated cameras, the bilinear sensor,
position noise), and the exact-semantics path (any lens train, dispersion,
absorbance, gradient-index noise, cameras rotated past 90 degrees, the
whole march menu, the ray dumps and their analysis), rendering across
devices (the particles split over a torch.distributed world), and the
volume's preparation on the card (the JAX package's native/ module).
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
