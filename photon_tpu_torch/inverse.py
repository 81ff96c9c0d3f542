"""Differentiable BOS inversion: recover a density field from images.

Counterpart of ``photon_tpu/inverse.py``.  The fast renderer is
differentiable with respect to the density field from end to end (volume
precompute, chief-ray march, ray fan, splat), on the card through the
backward kernels of ``ops/march_dense_fused.py``, ``ops/fan.py`` and
``ops/splat.py``, so pixel intensities have gradients with respect to rho.
This module wraps that into a gradient-descent inversion: given an observed
BOS image, recover rho on the volume grid.

Physics note: the forward only sees the refractive-index *gradient* along
ray paths, so the inversion recovers grad(n) projected onto the data; a
smoothness prior (Tikhonov on the Laplacian) regularises the nullspace.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.device import DeviceLike, as_f32, resolve_device
from photon_tpu_torch.models.optics import CameraSetup
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.models.scenes import LightfieldSource
from photon_tpu_torch.volume import (Z_ORIGIN_SHIFT, DensityVolume,
                                     build_density_volume)


def _grad_axis(f: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """Central differences inside, second-order one-sided at the faces."""
    n = f.shape[axis]
    take = lambda i: f.narrow(axis, i, 1)  # noqa: E731
    lo = (-1.5 * take(0) + 2.0 * take(1) - 0.5 * take(2)) / h
    interior = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) \
        / (2.0 * h)
    hi = (1.5 * take(n - 1) - 2.0 * take(n - 2) + 0.5 * take(n - 3)) / h
    return torch.cat([lo, interior, hi], dim=axis)


def volume_from_rho(rho: torch.Tensor, template: DensityVolume,
                    gladstone_dale: float = 0.225e-3) -> DensityVolume:
    """Rebuild the packed (grad n, n-1) field from a rho grid, in PyTorch.

    Differentiable twin of :func:`volume.build_density_volume`'s numpy
    precompute.  ``rho`` is a (W, H, D) float32 tensor indexed [x, y, z]
    like the NRRD layout.  Only ``field`` is replaced: the template's
    geometry and ``data_min`` stay (``n0 = 1 + data_min`` enters the march).
    """
    n_minus_1 = gladstone_dale * rho
    sp = [float(s) for s in template.grid_spacing]
    packed = torch.stack([_grad_axis(n_minus_1, 0, sp[0]),
                          _grad_axis(n_minus_1, 1, sp[1]),
                          _grad_axis(n_minus_1, 2, sp[2]),
                          n_minus_1], dim=-1)               # (W, H, D, 4)
    field = packed.permute(2, 1, 0, 3).contiguous()         # (D, H, W, 4)
    return template._replace(field=field.to(torch.float32))


@dataclass
class InversionResult:
    rho: np.ndarray
    losses: list
    volume: DensityVolume


def invert_bos(cfg: SimulationConfig, setup: CameraSetup,
               source: LightfieldSource, r1, r2,
               observed_image, template: DensityVolume,
               rho0: Optional[np.ndarray] = None,
               steps: int = 50, learning_rate: float = 1.0,
               smoothness: float = 0.0,
               algorithm: int = 2,
               callback: Optional[Callable] = None,
               device: DeviceLike = None) -> InversionResult:
    """Gradient-descent recovery of rho from an observed BOS image.

    Args:
      observed_image: (ny, nx) raw float image (the distorted im2).
      template: DensityVolume carrying the grid geometry; its field is
        ignored, ``rho0`` (default: uniform rho_0) seeds the solve.
      smoothness: Tikhonov weight on the 3-D Laplacian of rho.
      callback: called as ``callback(step, loss, rho)`` with rho a tensor.
      device: None is the CUDA device (raises without one).

    Returns rho on the template grid plus the loss history.
    """
    dev = resolve_device(device)
    w, h, d = template.sizes
    if rho0 is None:
        rho0 = np.full((w, h, d), cfg.density_gradients.rho_0,
                       dtype=np.float32)
    target = as_f32(observed_image, dev)
    gd = cfg.density_gradients.gladstone_dale

    def loss_fn(rho):
        vol = volume_from_rho(rho, template, gd)
        img = render_image_fast(cfg, setup, source, r1, r2, vol=vol,
                                algorithm=algorithm, device=dev)
        data = torch.mean((img - target) ** 2)
        if smoothness > 0.0:
            lap = (torch.diff(rho, 2, dim=0)[:, 1:-1, 1:-1] ** 2
                   + torch.diff(rho, 2, dim=1)[1:-1, :, 1:-1] ** 2
                   + torch.diff(rho, 2, dim=2)[1:-1, 1:-1, :] ** 2)
            return data + smoothness * torch.mean(lap)
        return data

    rho = as_f32(rho0, dev)
    losses = []
    # Adam keeps the step size meaningful across the tiny-gradient regime
    m = torch.zeros_like(rho)
    v = torch.zeros_like(rho)
    b1, b2, eps = 0.9, 0.999, 1e-12
    for t in range(1, steps + 1):
        rho.requires_grad_(True)
        loss = loss_fn(rho)
        (g,) = torch.autograd.grad(loss, rho)
        with torch.no_grad():
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            rho = rho - learning_rate * mhat / (torch.sqrt(vhat) + eps)
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(t, losses[-1], rho)

    rho_np = rho.cpu().numpy()
    vol = build_density_volume(
        rho_np, np.asarray(template.grid_spacing),
        [float(template.min_bound[0]), float(template.min_bound[1]),
         float(template.min_bound[2]) + Z_ORIGIN_SHIFT],
        gladstone_dale=gd, device=dev)
    return InversionResult(rho=rho_np, losses=losses, volume=vol)
