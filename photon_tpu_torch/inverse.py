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
from photon_tpu_torch.native import (grad_axis, gradient_field_transpose,
                                     launch_gradient_field)
from photon_tpu_torch.utils.profiling import span
from photon_tpu_torch.volume import (Z_ORIGIN_SHIFT, DensityVolume,
                                     build_density_volume)


class _StencilOnCard(torch.autograd.Function):
    """rho -> the packed field on the card: K10 on n-1 = gladstone_dale
    rho forward, K13 (``native.gradient_field_transpose``) backward.  The
    map is linear, so nothing is saved but its constants."""

    @staticmethod
    def forward(ctx, rho, spacing, gladstone_dale):
        ctx.spacing, ctx.gladstone_dale = spacing, gladstone_dale
        return launch_gradient_field((gladstone_dale * rho).contiguous(),
                                     spacing)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_field):
        return gradient_field_transpose(d_field, ctx.spacing,
                                        ctx.gladstone_dale), None, None


def volume_from_rho(rho: torch.Tensor, template: DensityVolume,
                    gladstone_dale: float = 0.225e-3) -> DensityVolume:
    """Rebuild the packed (grad n, n-1) field from a rho grid,
    differentiably.

    Differentiable twin of :func:`volume.build_density_volume`'s
    precompute.  ``rho`` is a (W, H, D) float32 tensor indexed [x, y, z]
    like the NRRD layout.  On a CUDA device the field is K10's (the
    float64 stencil of ``gladstone_dale * rho``, rounded once: what
    ``native.gradient_field`` gives) and its backward K13, one launch each
    (:class:`_StencilOnCard`).  On the CPU it is ``native.grad_axis`` in
    float32 under autograd, the JAX package's ``volume_from_rho``.  Only
    ``field`` is replaced: the template's geometry and ``data_min`` stay
    (``n0 = 1 + data_min`` enters the march).
    """
    sp = [float(s) for s in template.grid_spacing]
    if rho.device.type != "cpu":
        return template._replace(
            field=_StencilOnCard.apply(rho, sp, gladstone_dale))
    n_minus_1 = gladstone_dale * rho
    packed = torch.stack([grad_axis(n_minus_1, 0, sp[0]),
                          grad_axis(n_minus_1, 1, sp[1]),
                          grad_axis(n_minus_1, 2, sp[2]),
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
      algorithm: the march's integrator (``ray_tracing_algorithm``).
      callback: called as ``callback(step, loss, rho)`` with rho a tensor.
      device: None is the CUDA device (raises without one).

    The march samples under ``cfg.density_gradients.interpolation_scheme``,
    as ``run_bos`` renders the images the solve inverts: 1 trilinear, 2 the
    cubic B-spline (the field prefiltered into coefficients inside the
    march, K11 forward and K12 backward on the card).

    Returns rho on the template grid plus the loss history.

    Spans (``utils.profiling.span``): ``invert.step`` a step, enclosing
    ``invert.volume_from_rho``, ``invert.render`` (the render and the
    loss), ``invert.backward``, ``invert.adam``, ``invert.loss_read`` (the
    loss's wait on the device) and ``invert.callback``; after the steps
    ``invert.result_volume`` and ``invert.rho_to_host``.  Under the cubic
    scheme on the card the render holds ``native``'s
    ``prefilter.coefficients`` (K11) and the backward its
    ``prefilter.transpose`` (K12).
    """
    dev = resolve_device(device)
    w, h, d = template.sizes
    if rho0 is None:
        rho0 = np.full((w, h, d), cfg.density_gradients.rho_0,
                       dtype=np.float32)
    target = as_f32(observed_image, dev)
    gd = cfg.density_gradients.gladstone_dale
    scheme = int(cfg.density_gradients.interpolation_scheme)

    def loss_fn(rho):
        with span("invert.volume_from_rho"):
            vol = volume_from_rho(rho, template, gd)
        with span("invert.render"):
            img = render_image_fast(cfg, setup, source, r1, r2, vol=vol,
                                    algorithm=algorithm,
                                    interpolation_scheme=scheme,
                                    device=dev)
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
        with span("invert.step"):
            rho.requires_grad_(True)
            loss = loss_fn(rho)
            with span("invert.backward"):
                (g,) = torch.autograd.grad(loss, rho)
            with span("invert.adam"), torch.no_grad():
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mhat = m / (1 - b1 ** t)
                vhat = v / (1 - b2 ** t)
                rho = rho - learning_rate * mhat / (torch.sqrt(vhat) + eps)
            with span("invert.loss_read"):
                losses.append(float(loss.detach()))
            if callback is not None:
                with span("invert.callback"):
                    callback(t, losses[-1], rho)

    # the result volume from the grid where it lies (K10 on the card)
    with span("invert.result_volume"):
        vol = build_density_volume(
            rho, np.asarray(template.grid_spacing),
            [float(template.min_bound[0]), float(template.min_bound[1]),
             float(template.min_bound[2]) + Z_ORIGIN_SHIFT],
            gladstone_dale=gd, device=dev)
    with span("invert.rho_to_host"):
        rho_host = rho.cpu().numpy()
    return InversionResult(rho=rho_host, losses=losses, volume=vol)
