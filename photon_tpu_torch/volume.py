"""Refractive-index volume ingest and gradient precompute.

Counterpart of ``photon_tpu/volume.py`` (the reference's density-volume
setup, ``trace_rays_through_density_gradients.h``):

* NRRD load + Gladstone-Dale conversion rho -> (n - 1) = K rho —
  ref: loadNRRD (:1663-1817), including the fixed -750e3 shift applied to
  the z space origin (:1704)
* central / one-sided finite-difference grad(n) precompute into a packed
  (grad_n, n-1) field — ref: setData (:1820-2002), through
  ``native.gradient_field`` (the kernel K10 on a CUDA device, its plain
  version on the CPU)
* bounds/spacing/step-size bookkeeping — ref: readDatafromFile (:2004-2105)

The packed field is a (D, H, W, 4) float32 tensor indexed
``field[z, y, x] = (dn/dx, dn/dy, dn/dz, n-1)``: one voxel is one 16-byte
load for the march kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photon_tpu_torch.device import DeviceLike, as_f32, resolve_device
from photon_tpu_torch.native import gradient_field
from photon_tpu_torch.utils.profiling import span

# the reference shifts the volume's z origin by this fixed amount so that
# world-z (measured from the sensor) lines up with the volume
# (ref: trace_rays_through_density_gradients.h:1704 and the matching shift
# in the kernel, parallel_ray_tracing.cu:2045)
Z_ORIGIN_SHIFT = 750e3


class DensityVolume(NamedTuple):
    """Packed refractive-index field on one device + its geometry.

    The geometry stays on the host as float32 numpy arrays: the march forms
    its scalars from it on every call, and a device tensor would cost a
    synchronising copy each time.
    """

    field: torch.Tensor      # (D, H, W, 4) f32: (dn/dx, dn/dy, dn/dz, n-1)
    min_bound: np.ndarray    # (3,) f32 microns, host
    max_bound: np.ndarray    # (3,) f32, host
    grid_spacing: np.ndarray  # (3,) f32, host
    data_min: float         # min of (n-1) over the volume
    step_size: float        # min grid spacing (the marcher's base step)
    max_step_size: float    # max grid spacing

    @property
    def sizes(self):
        d, h, w, _ = self.field.shape
        return w, h, d


def build_density_volume(rho, spacings, space_origin,
                         gladstone_dale: float = 0.225e-3,
                         z_origin_shift: float = Z_ORIGIN_SHIFT,
                         device: DeviceLike = None) -> DensityVolume:
    """Pack a density grid (kg/m^3) into a marcher-ready volume on ``device``.

    n - 1 = K rho is formed in rho's precision, rounded to float32, moved to
    ``device`` and differentiated there (``native.gradient_field``: K10 on a
    CUDA device), as the JAX package rounds it for its native stencil;
    ``data_min`` is the minimum before the rounding.

    Args:
      rho: (W, H, D) density indexed [x, y, z]: a numpy array, or a float32
        tensor (on any device; ``invert_bos`` passes its device grid).  A
        float32 array and the same values as a tensor give the same bits.
      spacings: (dx, dy, dz) in microns.
      space_origin: (x0, y0, z0) in microns; z0 gets the reference's fixed
        -750e3 shift (ref: loadNRRD:1704).
      device: None = the CUDA device (raises without one); "cpu" for tests.

    Spans: ``volume.build``, enclosing ``volume.gradient`` (the stencil)
    and ``volume.data_min`` (the minimum read back to the host).
    """
    with span("volume.build"):
        dev = resolve_device(device)
        spacings = np.asarray(spacings, dtype=np.float64).ravel()
        origin = np.asarray(space_origin, dtype=np.float64).ravel().copy()
        origin[2] -= z_origin_shift

        if isinstance(rho, torch.Tensor):
            if rho.dtype != torch.float32:
                raise TypeError(f"rho: a tensor must be float32, got "
                                f"{rho.dtype}")
            n_minus_1 = gladstone_dale * rho.detach().to(dev)
            with span("volume.gradient"):
                field = gradient_field(n_minus_1.contiguous(), spacings)
            with span("volume.data_min"):
                data_min = float(n_minus_1.min())
        else:
            nm1 = (gladstone_dale * np.asarray(rho)).astype(np.float64)
            n_minus_1 = as_f32(nm1, dev)
            with span("volume.gradient"):
                field = gradient_field(n_minus_1, spacings)
            with span("volume.data_min"):
                data_min = float(nm1.min())

        sizes = np.array(n_minus_1.shape, dtype=np.float64)     # (W, H, D)
        min_bound = origin
        max_bound = origin + (sizes - 1.0) * spacings

        return DensityVolume(
            field=field,
            min_bound=min_bound.astype(np.float32),
            max_bound=max_bound.astype(np.float32),
            grid_spacing=spacings.astype(np.float32),
            data_min=data_min,
            step_size=float(spacings.min()),
            max_step_size=float(spacings.max()),
        )


def load_density_volume(path: str, gladstone_dale: float = 0.225e-3,
                        z_origin_shift: float = Z_ORIGIN_SHIFT,
                        device: DeviceLike = None) -> DensityVolume:
    """Load an NRRD density file into a marcher-ready volume.

    (ref: readDatafromFile:2004-2105 + loadNRRD:1663-1817)
    """
    from photon_tpu_torch.utils.nrrd_io import read_nrrd

    data, hdr = read_nrrd(path)
    return build_density_volume(
        data, hdr["spacings"], hdr["space origin"],
        gladstone_dale=gladstone_dale, z_origin_shift=z_origin_shift,
        device=device)
