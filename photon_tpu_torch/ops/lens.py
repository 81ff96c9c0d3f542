"""Lens and aperture propagation of ray bundles, the exact path.

Counterpart of ``photon_tpu/ops/lens.py`` (the reference's per-ray device
functions, parallel_ray_tracing.cu:239-1011 and :1274-1381): sphere
intersection, distance to the optical axis, the ideal thin lens, the thick
spherical lens with Abbe/Cauchy dispersion and absorbance, the aperture
stop, and the sequential traversal of a flattened train in light order.

A bundle holds (N, 3) positions and unit directions and (N,) wavelengths
and radiances, with the reference's NaN-poisoning convention: rays that miss
the pitch, suffer total internal reflection or miss a surface carry NaN and
are dropped by the sensor's finite mask.  Every dot product of 3-vectors is
written out as products and sums in the JAX package's order (no ``@`` or
``einsum``, which the card may run in TF32 or reassociate), in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from photon_tpu_torch.device import as_f32


class RayBundle(NamedTuple):
    """A batch of light rays (positions in microns, unit directions)."""

    pos: torch.Tensor         # (N, 3)
    dir: torch.Tensor         # (N, 3)
    wavelength: torch.Tensor  # (N,)
    radiance: torch.Tensor    # (N,)

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.pos).all(dim=-1) \
            & torch.isfinite(self.dir).all(dim=-1)


def dot3(a, b):
    """Row-wise dot product of (..., 3) tensors (a (3,) tensor broadcasts),
    summed x, y, z in turn."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _normalize(v):
    return v / torch.sqrt(dot3(v, v))[..., None]


def _poison(rays: RayBundle, bad) -> RayBundle:
    """Set rays where ``bad`` is True to NaN (the reference's failure path)."""
    nan1 = torch.ones_like(rays.radiance).masked_fill(bad, math.nan)
    nan3 = nan1[:, None]
    return RayBundle(rays.pos * nan3, rays.dir * nan3,
                     rays.wavelength * nan1, rays.radiance * nan1)


def ray_sphere_intersection(center, radius: float, direction, origin,
                            surface: str):
    """First intersection of rays with a spherical surface.

    ``surface`` is 'front' or 'back'; with the sign of ``radius`` it selects
    the root of the physically entered surface (the same branch for both,
    as in the reference: parallel_ray_tracing.cu:239-343).  Rays that miss
    return NaN positions.  ``beta^2 - 4 alpha gamma`` cancels from about
    1e16 in float32; it is formed as the JAX package forms it.
    """
    if surface not in ("front", "back"):
        raise ValueError(f"unknown surface {surface!r}")
    omc = origin - center
    alpha = dot3(direction, direction)
    beta = 2.0 * dot3(direction, omc)
    gamma = dot3(omc, omc) - radius * radius
    disc = beta * beta - 4.0 * alpha * gamma
    miss = disc < 0.0
    sq = torch.sqrt(torch.where(miss, 0.0, disc))
    t1 = (-beta + sq) / (2.0 * alpha)
    t2 = (-beta - sq) / (2.0 * alpha)
    t = torch.minimum(t1, t2) if radius > 0 else torch.maximum(t1, t2)
    t = torch.where(miss, math.nan, t)
    return origin + direction * t[:, None]


def distance_to_optical_axis(pos, axis_point, plane_normal):
    """Distance from points to the line through ``axis_point`` along
    ``plane_normal`` ((3,) tensors; ref: parallel_ray_tracing.cu:345-380)."""
    n = plane_normal
    t_min = dot3(n, pos - axis_point) / dot3(n, n)
    foot = axis_point + n * t_min[:, None]
    d = pos - foot
    return torch.sqrt(dot3(d, d))


def _refractive_index_ratio(n_element: float, abbe: float, wavelength,
                            entering: bool):
    """Snell ratio with optional Abbe/Cauchy dispersion: ``entering`` gives
    1/n_lambda (air -> glass), else n_lambda (glass -> air); a NaN ``abbe``
    is no dispersion (ref: parallel_ray_tracing.cu:618-643, :767-788)."""
    lambda_d, lambda_f, lambda_c = 589.3, 486.1, 656.3
    if math.isnan(abbe):
        n_lambda = torch.full_like(wavelength, n_element)
    else:
        dispersion = (1.0 / (wavelength * wavelength)
                      - float(np.float32(1.0 / lambda_d ** 2))) * float(
            np.float32((n_element - 1.0) / (
                abbe * (1.0 / lambda_f ** 2 - 1.0 / lambda_c ** 2))))
        n_lambda = float(np.float32(n_element)) + dispersion
    return 1.0 / n_lambda if entering else n_lambda


def _refract(direction, normal, ratio):
    """Snell refraction of unit rays about unit surface normals; returns
    (new_direction, tir_mask) (ref: :645-687)."""
    cos_i = -dot3(direction, normal)
    radicand = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    tir = radicand < 0.0
    k = ratio * cos_i - torch.sqrt(torch.where(tir, 0.0, radicand))
    out = direction * ratio[:, None] + k[:, None] * normal
    return _normalize(out), tir


def propagate_thin_lens(rays: RayBundle, center, plane, pitch: float,
                        focal_length: float) -> RayBundle:
    """Ideal thin-lens deflection at the lens plane (ref: :416-503)."""
    n = plane[:3]
    t_hit = -(dot3(rays.pos, n) + plane[3]) / dot3(rays.dir, n)
    hit = rays.pos + rays.dir * t_hit[:, None]
    r = distance_to_optical_axis(hit, center, n)
    rays = _poison(RayBundle(hit, rays.dir, rays.wavelength, rays.radiance),
                   r > pitch / 2.0)
    new_dir = _normalize(-(rays.pos - center) / focal_length + rays.dir)
    return RayBundle(rays.pos, new_dir, rays.wavelength, rays.radiance)


def propagate_thick_lens(rays: RayBundle, center, plane, pitch: float,
                         vertex_distance: float, front_radius: float,
                         back_radius: float, refractive_index: float,
                         abbe_number: float, transmission_ratio: float,
                         absorbance_rate: float) -> RayBundle:
    """Two-surface spherical lens with Snell refraction (ref: :507-864)."""
    n_hat = plane[:3] / torch.sqrt(dot3(plane[:3], plane[:3]))

    # front surface
    front_center = center + n_hat * (vertex_distance / 2.0 - front_radius)
    hit = ray_sphere_intersection(front_center, front_radius, rays.dir,
                                  rays.pos, "front")
    r = distance_to_optical_axis(hit, center, n_hat)
    rays = _poison(RayBundle(hit, rays.dir, rays.wavelength, rays.radiance),
                   ~(r <= pitch / 2.0))
    normal = _normalize(rays.pos - front_center)
    ratio = _refractive_index_ratio(refractive_index, abbe_number,
                                    rays.wavelength, entering=True)
    new_dir, tir = _refract(rays.dir, normal, ratio)
    rays = _poison(RayBundle(rays.pos, new_dir, rays.wavelength,
                             rays.radiance), tir)

    # back surface
    back_center = center + n_hat * (-vertex_distance / 2.0 - back_radius)
    entry_pos = rays.pos
    hit = ray_sphere_intersection(back_center, back_radius, rays.dir,
                                  rays.pos, "back")
    r = distance_to_optical_axis(hit, center, n_hat)
    rays = _poison(RayBundle(hit, rays.dir, rays.wavelength, rays.radiance),
                   ~(r <= pitch / 2.0))
    normal = -_normalize(rays.pos - back_center)
    ratio = _refractive_index_ratio(refractive_index, abbe_number,
                                    rays.wavelength, entering=False)
    new_dir, tir = _refract(rays.dir, normal, ratio)

    # radiance: absorbance over the glass path, else transmission scaling;
    # the reference multiplies, rather than exponentiates, the absorbance
    # path length (ref: :838-853), reproduced as-is
    if absorbance_rate != 0.0:
        d = rays.pos - entry_pos
        radiance = (1.0 - absorbance_rate) * rays.radiance \
            * torch.sqrt(dot3(d, d))
    else:
        radiance = transmission_ratio * rays.radiance
    return _poison(RayBundle(rays.pos, new_dir, rays.wavelength, radiance),
                   tir)


def propagate_aperture(rays: RayBundle, center, plane, pitch: float,
                       vertex_distance: float) -> RayBundle:
    """Aperture stop: two planar pitch culls (ref: :868-992)."""
    n = plane[:3]
    norm_mag = torch.sqrt(dot3(n, n))
    for ds in (-vertex_distance / 2.0, vertex_distance / 2.0):
        d_plane = plane[3] - ds * norm_mag
        t_hit = -(dot3(rays.pos, n) + d_plane) / dot3(rays.dir, n)
        hit = rays.pos + rays.dir * t_hit[:, None]
        r = distance_to_optical_axis(hit, center, n)
        rays = _poison(RayBundle(hit, rays.dir, rays.wavelength,
                                 rays.radiance), ~(r <= pitch / 2.0))
    return rays


def propagate_system(rays: RayBundle, stack, lens_model: str) -> RayBundle:
    """Propagate rays through the flattened optical train in light order.

    The train is defined sensor-outward, so traversal reverses the system
    index (ref: propagate_rays_through_optical_system:1419-1485).
    ``lens_model`` 'thin-lens' sends every lens element through the ideal
    thin lens, the reference's element-type override
    (ref: perform_ray_tracing_03.py:1803-1808).
    """
    dev = rays.pos.device
    order = np.argsort(-np.asarray(stack.system_index), kind="stable")
    for e in order:
        center = as_f32(stack.center[e], dev)
        plane = as_f32(stack.plane_parameters[e], dev)
        etype = int(stack.element_type[e])
        if etype == 0 and lens_model == "thin-lens":
            rays = propagate_thin_lens(
                rays, center, plane, float(stack.pitch[e]),
                float(stack.thin_lens_focal_length[e]))
        elif etype == 0:
            rays = propagate_thick_lens(
                rays, center, plane, float(stack.pitch[e]),
                float(stack.vertex_distance[e]),
                float(stack.front_surface_radius[e]),
                float(stack.back_surface_radius[e]),
                float(stack.refractive_index[e]),
                float(stack.abbe_number[e]),
                float(stack.transmission_ratio[e]),
                float(stack.absorbance_rate[e]))
        elif etype == 1:
            rays = propagate_aperture(
                rays, center, plane, float(stack.pitch[e]),
                float(stack.vertex_distance[e]))
        else:
            raise NotImplementedError("mirror elements are not supported")
    return rays
