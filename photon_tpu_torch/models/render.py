"""The exact-semantics renderer: source -> rays -> (march) -> lens -> sensor.

Counterpart of ``photon_tpu/models/render.py`` (the reference's kernel and
host runtime, parallel_ray_tracing.cu):

* ray generation, diffuse or with Mie scattering per ray in the world frame
  (generate_lightfield_angular_data :71-237);
* the camera <-> world rotation around the density volume and the z shift
  (kernel body :2036-2129);
* the apparent-image (pinhole + magnification) lens model
  (create_apparent_image :1545-1733), or the optical train of
  ``ops/lens.py`` (any tilt, any number of elements, dispersion,
  absorbance);
* the sensor of ``ops/sensor.py``, with optional position noise.

Every ray of a chunk of particles is one row of a (P*R, 3) bundle, and
:func:`render_image` sums the chunks' images as the reference's KMAX loop
does (:3506-3515).  :class:`RenderParams` is shared with the fast renderer
(``models/render_fast.py``).  Rotations are written out as products and
sums in the JAX package's order, never as ``@``: a position of ~7.5e5 um
would lose hundreds of microns to TF32 on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.device import DeviceLike, as_f32, resolve_device
from photon_tpu_torch.models.optics import CameraSetup
from photon_tpu_torch.models.scenes import LightfieldSource
from photon_tpu_torch.ops.lens import RayBundle, dot3, propagate_system
from photon_tpu_torch.ops.sensor import bilinear_splat, diffraction_splat


@dataclass(frozen=True)
class RenderParams:
    """Static parameters of the forward pass."""

    nx: int
    ny: int
    pixel_pitch: float
    z_sensor: float
    lens_pitch: float
    image_distance: float
    aperture_f_number: float
    ray_cone_pitch_ratio: float
    lens_model: str                  # 'general' | 'thin-lens' | 'apparent'
    implement_diffraction: bool
    diffraction_diameter: float
    beam_wavelength: float
    z_offset: float
    object_distance: float
    thin_lens_focal_length: float
    add_pos_noise: bool = False
    pos_noise_std: float = 0.0       # fraction of a pixel

    @classmethod
    def from_setup(cls, cfg: SimulationConfig, setup: CameraSetup,
                   source: LightfieldSource) -> "RenderParams":
        cd = cfg.camera_design
        if cfg.simulation_type == "piv":
            beam_wavelength = cfg.particle_field.beam_wavelength
        else:
            beam_wavelength = 0.0
        return cls(
            nx=int(cd.x_pixel_number), ny=int(cd.y_pixel_number),
            pixel_pitch=float(cd.pixel_pitch),
            z_sensor=float(setup.z_sensor),
            lens_pitch=float(setup.lens_pitch),
            image_distance=float(setup.image_distance),
            aperture_f_number=float(setup.aperture_f_number),
            ray_cone_pitch_ratio=float(cfg.lens_design.ray_cone_pitch_ratio),
            lens_model=str(setup.lens_model),
            implement_diffraction=bool(cd.implement_diffraction),
            diffraction_diameter=float(cd.diffraction_diameter),
            beam_wavelength=float(beam_wavelength),
            z_offset=float(source.z_offset),
            object_distance=float(source.object_distance),
            thin_lens_focal_length=float(
                setup.elements.thin_lens_focal_length[0]),
            add_pos_noise=bool(cfg.density_gradients.add_pos_noise),
            pos_noise_std=float(cfg.density_gradients.pos_noise_std),
        )


# ---------------------------------------------------------------------------
# Ray generation
# ---------------------------------------------------------------------------


def _rotate(m, v):
    """``v @ m.T`` for (N, 3) rows ``v`` and a 3 x 3 matrix ``m`` given as
    nested lists of float32 values, each component summed x, y, z."""
    return torch.stack([m[i][0] * v[:, 0] + m[i][1] * v[:, 1]
                        + m[i][2] * v[:, 2] for i in range(3)], dim=-1)


def _f32_rows(m) -> list:
    """A 3 x 3 matrix as nested lists of float32 values."""
    return np.asarray(m, np.float32).tolist()


def _unit(v):
    return v / torch.sqrt(dot3(v, v))[..., None]


def generate_rays(source_x, source_y, source_z, source_radiance,
                  diameter_index, r1, r2, params: RenderParams,
                  scattering=None, inverse_rotation_matrix=None,
                  beam_propagation_vector=None) -> RayBundle:
    """Spawn the (P, R) ray fan from each source point toward the lens cone;
    returns a flat bundle of P*R rays, particle-major.

    ``r1`` / ``r2``: the (R,) uniform samples shared by every source point;
    the cone radius is ``ray_cone_pitch_ratio * lens_pitch * r1`` with no
    square root, as in the reference (:104-130).  ``scattering``: (angles
    (A,), table (A, D)) tensors of a Mie irradiance table; the radiance then
    follows the scattering angle between the world-frame ray and the beam
    (:144-210); else the source radiance is used (diffuse)."""
    P = source_x.shape[0]
    R = r1.shape[0]
    cone = params.ray_cone_pitch_ratio * params.lens_pitch
    # the angle's cosine and sine in float64, rounded once: the card's and
    # the CPU's float32 cos differ in the last bit, and an adaptive march
    # (RK45) turns one ulp of a ray into another sequence of steps
    ang = (2.0 * math.pi * r2).double()
    x_lens = cone * r1 * torch.cos(ang).to(r2.dtype)              # (R,)
    y_lens = cone * r1 * torch.sin(ang).to(r2.dtype)
    if R == 1:
        x_lens = torch.zeros_like(x_lens)   # chief ray only (ref: :111-116)
        y_lens = torch.zeros_like(y_lens)

    denom = (params.image_distance - source_z)[:, None]         # (P, 1)
    tan_theta = -(x_lens[None, :] - source_x[:, None]) / denom
    tan_phi = -(y_lens[None, :] - source_y[:, None]) / denom
    d = torch.stack([tan_theta, tan_phi, -torch.ones_like(tan_theta)],
                    dim=-1)
    d = _unit(d)                                                # (P, R, 3)
    pos = torch.stack([source_x, source_y, source_z], dim=-1)[:, None, :] \
        .expand(P, R, 3)

    if scattering is not None:
        angles, table = scattering
        inv_rot = _f32_rows(inverse_rotation_matrix)
        beam = [float(v) for v in np.asarray(beam_propagation_vector,
                                            np.float32)]
        world_dir = _unit(_rotate(inv_rot, d.reshape(P * R, 3)))
        cosang = (beam[0] * world_dir[:, 0] + beam[1] * world_dir[:, 1]
                  + beam[2] * world_dir[:, 2]).clamp(-1.0, 1.0)
        scatter_angle = torch.arccos(cosang).reshape(P, R)
        # linear interpolation on the uniform angle grid (ref: :186-201)
        del_angle = angles[1] - angles[0]
        a = (scatter_angle - angles[0]) / del_angle
        a0 = torch.floor(a).to(torch.int64).clamp(0, table.shape[0] - 2)
        frac = a - a0.to(a.dtype)
        col = diameter_index.to(torch.int64)[:, None]
        irr_l = table[a0, col]                                  # (P, R)
        irr_u = table[a0 + 1, col]
        irradiance = (irr_l + frac * (irr_u - irr_l)) \
            * source_radiance[:, None]
    else:
        irradiance = source_radiance[:, None].expand(P, R)

    radiance = irradiance / (params.aperture_f_number ** 2)
    wavelength = torch.full((P * R,), params.beam_wavelength,
                            dtype=torch.float32, device=source_x.device)
    return RayBundle(pos.reshape(P * R, 3), d.reshape(P * R, 3), wavelength,
                     radiance.reshape(P * R))


# ---------------------------------------------------------------------------
# Lens-model stages
# ---------------------------------------------------------------------------


def apparent_image_rays(rays: RayBundle, params: RenderParams) -> RayBundle:
    """Pinhole 'apparent image' model: no lens tracing, magnification only.

    Reverses the ray, intersects the object plane and scales by the
    thin-lens magnification with inversion; the positions returned are the
    image-plane coordinates the splat takes (ref: create_apparent_image
    :1545-1648)."""
    z_object = params.object_distance + params.z_offset
    direction = -rays.dir
    # plane -z + z_object = 0
    t_hit = -(-rays.pos[:, 2] + z_object) / (-direction[:, 2])
    hit = rays.pos + direction * t_hit[:, None]
    f = params.thin_lens_focal_length
    magnification = f / (z_object - params.z_offset - f)
    x_img = -hit[:, 0] * magnification
    y_img = -hit[:, 1] * magnification
    pos = torch.stack([x_img, y_img, torch.zeros_like(x_img)], dim=-1)
    return RayBundle(pos, direction, rays.wavelength, rays.radiance)


def _apply_position_noise(rays: RayBundle, params: RenderParams,
                          normals) -> RayBundle:
    """Gaussian sensor-position noise: ``normals`` ((N, 2) standard normals)
    times std * pixel_pitch added to the final intersection before the pixel
    mapping (all three sensor paths of the reference do this identically;
    ref: parallel_ray_tracing.cu:1424-1434, :1607-1615, :1773-1781)."""
    if not params.add_pos_noise:
        return rays
    if normals is None:
        raise ValueError("position noise needs its normals")
    scale = float(np.float32(params.pos_noise_std * params.pixel_pitch))
    noise = normals * scale
    pos = torch.stack([rays.pos[:, 0] + noise[:, 0],
                       rays.pos[:, 1] + noise[:, 1], rays.pos[:, 2]], dim=-1)
    return RayBundle(pos, rays.dir, rays.wavelength, rays.radiance)


def apparent_image_splat(rays: RayBundle, params: RenderParams, image,
                         normals=None):
    """Apparent-image model + full-circle erf splat (render_fraction 1)
    (ref: create_apparent_image:1545-1733)."""
    img_rays = _apply_position_noise(apparent_image_rays(rays, params),
                                     params, normals)
    return image + diffraction_splat(
        img_rays.pos, img_rays.dir, img_rays.radiance, img_rays.valid,
        nx=params.nx, ny=params.ny, pixel_pitch=params.pixel_pitch,
        diameter=params.diffraction_diameter, render_fraction=1.0,
        mirror_x=True)


def sensor_plane_rays(rays: RayBundle, params: RenderParams) -> RayBundle:
    """Advance rays to the sensor plane (ref: :1404-1438)."""
    t_hit = -(rays.pos[:, 2] - params.z_sensor) / rays.dir[:, 2]
    hit = rays.pos + rays.dir * t_hit[:, None]
    return RayBundle(hit, rays.dir, rays.wavelength, rays.radiance)


def sensor_splat(rays: RayBundle, params: RenderParams, image,
                 normals=None):
    """Intersect the sensor plane and deposit radiance (ref:
    intersect_sensor_02 / intersect_sensor dispatch at
    parallel_ray_tracing.cu:2178-2241)."""
    on_sensor = _apply_position_noise(sensor_plane_rays(rays, params),
                                      params, normals)
    if params.implement_diffraction:
        return image + diffraction_splat(
            on_sensor.pos, on_sensor.dir, on_sensor.radiance,
            on_sensor.valid, nx=params.nx, ny=params.ny,
            pixel_pitch=params.pixel_pitch,
            diameter=params.diffraction_diameter, render_fraction=0.75,
            mirror_x=True)
    return image + bilinear_splat(
        on_sensor.pos, on_sensor.dir, on_sensor.radiance, on_sensor.valid,
        nx=params.nx, ny=params.ny, pixel_pitch=params.pixel_pitch)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def _generate_and_march(chunk, params: RenderParams, march_fn,
                        rotation_matrix, inverse_rotation_matrix,
                        scattering_static) -> RayBundle:
    """Ray generation and, with ``march_fn``, the density-gradient stage in
    the world frame (camera -> world undoes the z shift and the camera's
    rotation; ref: parallel_ray_tracing.cu:2036-2082)."""
    x, y, z, radiance, diam, r1, r2 = chunk
    rays = generate_rays(
        x, y, z, radiance, diam, r1, r2, params,
        scattering=scattering_static.get("table"),
        inverse_rotation_matrix=scattering_static.get("inv_rot"),
        beam_propagation_vector=scattering_static.get("beam"))
    if march_fn is None:
        return rays
    shift = float(np.float32(params.z_offset + 750e3))
    inv_rot = _f32_rows(inverse_rotation_matrix)
    rot = _f32_rows(rotation_matrix)
    shifted = torch.stack([rays.pos[:, 0] - 0.0, rays.pos[:, 1] - 0.0,
                           rays.pos[:, 2] - shift], dim=-1)
    rays_w = march_fn(RayBundle(_rotate(inv_rot, shifted),
                                _rotate(inv_rot, rays.dir),
                                rays.wavelength, rays.radiance))
    pos_c = _rotate(rot, rays_w.pos)
    pos_c = torch.stack([pos_c[:, 0] + 0.0, pos_c[:, 1] + 0.0,
                         pos_c[:, 2] + shift], dim=-1)
    dir_c = _unit(_rotate(rot, rays_w.dir))
    return RayBundle(pos_c, dir_c, rays.wavelength, rays_w.radiance)


def trace_chunk(chunk, params: RenderParams, stack, march_fn,
                rotation_matrix, inverse_rotation_matrix,
                scattering_static, normals=None):
    """Render one particle chunk into a partial (ny, nx) image.

    ``chunk``: (x, y, z, radiance, diameter_index, r1, r2) tensors on one
    device; ``march_fn``: None or rays -> rays (the density stage);
    ``normals``: the chunk's (P*R, 2) standard normals of the position
    noise (None without it)."""
    rays = _generate_and_march(chunk, params, march_fn, rotation_matrix,
                               inverse_rotation_matrix, scattering_static)
    image = torch.zeros((params.ny, params.nx), dtype=torch.float32,
                        device=rays.pos.device)
    if params.lens_model == "apparent":
        return apparent_image_splat(rays, params, image, normals=normals)
    rays = propagate_system(rays, stack, params.lens_model)
    return sensor_splat(rays, params, image, normals=normals)


def trace_final_rays(chunk, params: RenderParams, stack, march_fn,
                     rotation_matrix, inverse_rotation_matrix,
                     scattering_static, normals=None) -> RayBundle:
    """The full pipeline up to the sensor plane, returning the final per-ray
    state instead of an image: the analogue of the reference's saved pos/dir
    dumps (ref: parallel_ray_tracing.cu:3561-3670).  The dumps record the
    intersection after the position noise."""
    rays = _generate_and_march(chunk, params, march_fn, rotation_matrix,
                               inverse_rotation_matrix, scattering_static)
    if params.lens_model == "apparent":
        rays = apparent_image_rays(rays, params)
    else:
        rays = sensor_plane_rays(
            propagate_system(rays, stack, params.lens_model), params)
    return _apply_position_noise(rays, params, normals)


def _scattering_static(scattering, dev: torch.device):
    if scattering is None:
        return {}
    return {
        "table": (as_f32(scattering["scattering_angle"], dev),
                  as_f32(scattering["scattering_irradiance"], dev)),
        "inv_rot": np.asarray(scattering["inverse_rotation_matrix"],
                              dtype=np.float32),
        "beam": np.asarray(scattering["beam_propogation_vector"],
                           dtype=np.float32),
    }


def _chunk_tensors(source: LightfieldSource, sl, dev: torch.device):
    return (as_f32(source.x[sl], dev), as_f32(source.y[sl], dev),
            as_f32(source.z[sl], dev), as_f32(source.radiance[sl], dev),
            torch.as_tensor(np.asarray(source.diameter_index[sl], np.int64),
                            device=dev))


def render_rays(cfg: SimulationConfig, setup: CameraSetup,
                source: LightfieldSource, r1, r2, march_fn=None,
                scattering=None, normals=None,
                device: DeviceLike = None) -> RayBundle:
    """Trace all rays and return their final positions and directions,
    particle-major (particle p's rays are rows p*R .. (p+1)*R - 1, the
    reference's dump layout).  ``normals``: (P*R, 2) standard normals of the
    position noise, or None without it.  For analysis-scale budgets; use
    :func:`render_image` for images."""
    dev = resolve_device(device)
    params = RenderParams.from_setup(cfg, setup, source)
    chunk = _chunk_tensors(source, slice(None), dev) + (
        as_f32(r1, dev), as_f32(r2, dev))
    return trace_final_rays(chunk, params, setup.elements, march_fn,
                            setup.rotation_matrix,
                            setup.inverse_rotation_matrix,
                            _scattering_static(scattering, dev),
                            normals=normals)


def render_image(cfg: SimulationConfig, setup: CameraSetup,
                 source: LightfieldSource, r1, r2,
                 march_fn=None, scattering=None,
                 rays_per_chunk: int = 2_000_000,
                 noise_seed: Optional[int] = None,
                 device: DeviceLike = None) -> torch.Tensor:
    """Render the raw (ny, nx) float32 image of a light-field source.

    Chunks particles so that at most ``rays_per_chunk`` rays are in flight
    (the reference's KMAX relaunch loop, ref: parallel_ray_tracing.cu
    :3506-3515) and sums the chunks' images.  ``march_fn``: None or a
    rays -> rays stage on ``device`` (``ops/march.make_march_fn``);
    ``scattering``: the Mie table dict of ``ops/mie.py``, or None.  Position
    noise draws each chunk's normals in turn from one generator on
    ``device`` seeded with ``noise_seed`` (``cfg.seed`` when None); the JAX
    package's draws cannot be repeated.  ``device``: None is the CUDA device
    (raises without one); the tests pass "cpu"."""
    dev = resolve_device(device)
    params = RenderParams.from_setup(cfg, setup, source)
    R = int(source.lightray_number_per_particle)
    P = source.num_particles
    chunk_p = max(1, min(P, rays_per_chunk // max(R, 1)))
    r1 = as_f32(r1, dev)
    r2 = as_f32(r2, dev)
    static = _scattering_static(scattering, dev)
    gen = None
    if params.add_pos_noise:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.seed if noise_seed is None else noise_seed))
    image = torch.zeros((params.ny, params.nx), dtype=torch.float32,
                        device=dev)
    for s in range(0, P, chunk_p):
        sl = slice(s, min(s + chunk_p, P))
        normals = None if gen is None else torch.randn(
            ((sl.stop - s) * R, 2), generator=gen, device=dev,
            dtype=torch.float32)
        image += trace_chunk(
            _chunk_tensors(source, sl, dev) + (r1, r2), params,
            setup.elements, march_fn, setup.rotation_matrix,
            setup.inverse_rotation_matrix, static, normals=normals)
    return image
