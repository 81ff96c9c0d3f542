"""Fast forward renderer: the (P particles, R rays) pipeline.

Counterpart of ``photon_tpu/models/render_fast.py``.  The renderer keeps the
*particle* structure of the problem explicit:

* density march: one chief ray per particle through the volume
  (``ops/march_dense_fused.py``), its deflection broadcast to the
  particle's ray fan (exact to the ~1 um lens-cone width);
* ray generation -> lens -> sensor statistics: per-particle sums over the
  fan (``ops/fan.py``), no (P, R) array on the card;
* sensor: one erf spot per particle at its amplitude-weighted centroid
  (``ops/sensor_fast.py`` -> ``ops/splat.py``).

This slice covers the main configuration: the axis-aligned single-lens
train with the 'apparent', 'thin-lens' or 'general' lens model, the erf
diffraction sensor, an unrotated camera, diffuse or Mie scattering (the
table collapsed to one factor a particle on the host,
:func:`mie_irradiance`), and a density volume of any slab size marched with
any integrator of the menu (Euler, RK4, RK4 with substeps given or chosen
from the data, Adams-Bashforth) under trilinear or cubic B-spline
interpolation.  Every other option raises ``NotImplementedError`` naming the
ROADMAP.md item that brings it; nothing falls through to another path.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.device import DeviceLike, as_f32, resolve_device
from photon_tpu_torch.models.optics import CameraSetup
from photon_tpu_torch.models.render import RenderParams
from photon_tpu_torch.models.scenes import LightfieldSource
from photon_tpu_torch.ops.fan import FanScalars, fan_stats
from photon_tpu_torch.ops.march_dense import (check_march_options,
                                              chief_deltas_dense,
                                              choose_substeps)
from photon_tpu_torch.ops.sensor_fast import particle_splat
from photon_tpu_torch.roadmap import (CONFIGS, EXACT_PATH, MULTI_DEVICE,
                                      later)
from photon_tpu_torch.volume import DensityVolume


def _axis_aligned(setup: CameraSetup) -> bool:
    """The fast lens path needs the untilted single-element train."""
    st = setup.elements
    return (st.num_elements == 1
            and np.allclose(st.plane_parameters[0][:3], [0, 0, 1])
            and np.allclose(st.center[0][:2], [0, 0]))


def _chief_geometry(xs, ys, zs, inv_rot, z_offset, image_distance):
    """Per-particle chief ray (toward the lens centre), world frame.

    Returns (x, y, z, dirx, diry, dirz), all (P,) tensors.  The frame shift
    ``z_offset + 750e3`` is summed in float64 and rounded once.  (The JAX
    function also returns the entry point and slopes at the volume top,
    which only its voxel-tube march reads.)
    """
    shift = float(np.float32(z_offset + 750e3))
    dden = image_distance - zs
    ctx = xs / dden
    cty = ys / dden
    cinv = 1.0 / torch.sqrt(ctx * ctx + cty * cty + 1.0)
    cdir_cam = torch.stack([ctx * cinv, cty * cinv, -cinv])   # (3, P)
    cpos_cam = torch.stack([xs, ys, zs - shift])
    cdir_w = inv_rot @ cdir_cam
    cpos_w = inv_rot @ cpos_cam
    return tuple(c.contiguous() for c in (cpos_w[0], cpos_w[1], cpos_w[2],
                                          cdir_w[0], cdir_w[1], cdir_w[2]))


# substep counts chosen for algorithm 3, by interpolation scheme and scene
_substep_cache = {}


def _scene_fingerprint(vol, setup, params, source) -> int:
    """Hash of everything the substep probe reads but the field's values
    (as the JAX package keys its cache)."""
    return hash((
        tuple(int(s) for s in vol.sizes),
        np.asarray(vol.min_bound).tobytes(),
        np.asarray(vol.max_bound).tobytes(),
        np.asarray(setup.inverse_rotation_matrix).tobytes(),
        float(params.z_offset), float(params.image_distance),
        *(np.asarray(a, np.float32).tobytes()
          for a in (source.x, source.y, source.z))))


def auto_patch(params: RenderParams) -> int:
    """Patch side for one erf spot per particle at its ray centroid: the
    circular render mask (radius rf * D px, ref parallel_ray_tracing.cu
    :1514-1519) zeroes everything farther out, and the patch anchor rounds
    the centroid to <= 0.5 px, so a side of 2 * rf * D + 3 px contains
    every nonzero pixel."""
    rf = 1.0 if params.lens_model == "apparent" else 0.75
    return max(6, math.ceil(2.0 * rf * params.diffraction_diameter + 3.0))


def mie_irradiance(image_distance: float, source: LightfieldSource,
                   scattering) -> np.ndarray:
    """(P,) float32 Mie irradiance factor of each particle.

    The per-ray scattering angles within a particle's ~1 um lens cone agree
    to ~1e-6 rad, so the table lookup collapses to one linear interpolation
    a particle, in angle, of its diameter's column, at the angle between its
    chief ray (toward the lens centre) and the beam vector; host float64
    numpy as in the JAX package (ref per-ray version:
    parallel_ray_tracing.cu:144-210).  The camera frame is the world frame:
    the caller holds the camera unrotated.  ``scattering``: the dict of
    ``ops/mie.create_mie_scattering_data``.
    """
    angles = np.asarray(scattering["scattering_angle"])
    table = np.asarray(scattering["scattering_irradiance"],
                       dtype=np.float32)                  # (A, D)
    beam = np.asarray(scattering["beam_propogation_vector"],
                      dtype=np.float64)
    diam_idx = np.asarray(source.diameter_index, np.int32)
    dden = image_distance - np.asarray(source.z, np.float64)
    ctx = np.asarray(source.x, np.float64) / dden
    cty = np.asarray(source.y, np.float64) / dden
    cinv = 1.0 / np.sqrt(ctx * ctx + cty * cty + 1.0)
    cosang = np.clip(beam[0] * ctx * cinv + beam[1] * cty * cinv
                     + beam[2] * (-cinv), -1.0, 1.0)
    a = (np.arccos(cosang) - angles[0]) / (angles[1] - angles[0])
    a0 = np.clip(np.floor(a).astype(np.int32), 0, table.shape[0] - 2)
    frac = (a - a0).astype(np.float32)
    rows = table.T[diam_idx]                              # (P, A)
    irr_l = rows[np.arange(len(a0)), a0]
    irr_u = rows[np.arange(len(a0)), a0 + 1]
    return irr_l + frac * (irr_u - irr_l)


def fan_scalars(params: RenderParams, lens_params) -> FanScalars:
    """Pack the scalar configuration of the fan chain."""
    z_object = params.object_distance + params.z_offset
    f = params.thin_lens_focal_length
    return FanScalars(
        image_distance=float(params.image_distance),
        shift=float(params.z_offset) + 750e3,
        z_object=float(z_object),
        magnification=float(f / (z_object - params.z_offset - f)),
        z_lens=float(lens_params[0]), pitch=float(lens_params[1]),
        focal_length=float(f), vertex=float(lens_params[2]),
        r_front=float(lens_params[3]), r_back=float(lens_params[4]),
        n_lens=float(lens_params[5]),
        nx=int(params.nx), ny=int(params.ny),
        pixel_pitch=float(params.pixel_pitch),
        z_sensor=float(params.z_sensor))


def render_image_fast(cfg: SimulationConfig, setup: CameraSetup,
                      source: LightfieldSource, r1, r2,
                      vol: Optional[DensityVolume] = None,
                      algorithm: int = 2,
                      patch: Optional[int] = None,
                      particles_per_chunk: Optional[int] = None,
                      chief_march: bool = True,
                      per_ray_splat: bool = False,
                      scattering=None,
                      mesh=None,
                      interpolation_scheme: int = 1,
                      dense_march: Optional[bool] = None,
                      march_substeps: Optional[int] = None,
                      device: DeviceLike = None) -> torch.Tensor:
    """Render the raw (ny, nx) float32 image with the (P, R) pipeline.

    ``r1``/``r2``: (R,) lens-aperture samples shared by all particles
    (numpy arrays or tensors).  ``vol``: density volume on ``device``, or
    None for the reference image.  ``particles_per_chunk``: render the
    particles in chunks of this size and sum the chunk images.
    ``scattering``: the Mie table dict of ``ops/mie.py``
    (:func:`mie_irradiance`), or None for diffuse scattering.
    ``dense_march``: accepted for the JAX package's callers and without
    effect on the route.  There it chooses between three marches by the
    slab's size (None: dense up to 256 x 256, windowed above; True: dense,
    and an error above; False: the voxel-tube march); here one gather march
    (``ops/march_dense_fused.march_chief_fused``) serves every size, and its
    render is within the bound that package's tests hold its marches to each
    other (L1 2e-3 of the image sum; tests/test_torch_large_volume.py).
    ``device``: None is the CUDA device (raises without one); the tests
    pass "cpu".
    """
    dev = resolve_device(device)
    params = RenderParams.from_setup(cfg, setup, source)
    if not _axis_aligned(setup):
        raise later("a tilted or multi-element lens train", EXACT_PATH)
    if mesh is not None:
        raise later("rendering across devices (mesh)", MULTI_DEVICE)
    if params.add_pos_noise:
        raise later("per-ray sensor position noise", CONFIGS)
    if not params.implement_diffraction:
        raise later("the bilinear sensor", CONFIGS)
    if per_ray_splat:
        raise later("per_ray_splat", CONFIGS)
    if not chief_march:
        raise later("chief_march=False (marching every fan ray)",
                    CONFIGS)
    if not np.allclose(setup.rotation_matrix, np.eye(3)):
        raise later("a rotated camera", CONFIGS)
    if params.lens_model not in ("apparent", "thin-lens", "general"):
        raise ValueError(f"unknown lens_model {params.lens_model!r}")
    if vol is not None:
        check_march_options(algorithm, interpolation_scheme)
        if vol.field.device != dev:
            raise ValueError(f"volume on {vol.field.device}, render on {dev}")
    elif dense_march:
        raise ValueError("dense_march=True requires a density volume")
    if patch is None:
        patch = auto_patch(params)

    xs = as_f32(source.x, dev)
    ys = as_f32(source.y, dev)
    zs = as_f32(source.z, dev)
    rad = source.radiance
    if scattering is not None:
        # the Mie factor folds into the radiance, before amp0's scale
        rad = np.asarray(rad, np.float32) * mie_irradiance(
            params.image_distance, source, scattering)
    rad = as_f32(rad, dev)
    r1 = as_f32(r1, dev)
    r2 = as_f32(r2, dev)
    P, R = xs.shape[0], r1.shape[0]

    st = setup.elements
    lens_params = (float(setup.z_lens), float(st.pitch[0]),
                   float(st.vertex_distance[0]),
                   float(st.front_surface_radius[0]),
                   float(st.back_surface_radius[0]),
                   float(st.refractive_index[0]),
                   float(st.transmission_ratio[0]))
    sc = fan_scalars(params, lens_params)

    # lens-aperture sample offsets, shared by all particles (ref: :104-130)
    cone = params.ray_cone_pitch_ratio * params.lens_pitch
    x_lens = cone * r1 * torch.cos(2.0 * math.pi * r2)
    y_lens = cone * r1 * torch.sin(2.0 * math.pi * r2)
    if R == 1:
        x_lens = torch.zeros_like(x_lens)
        y_lens = torch.zeros_like(y_lens)
    amp_scale = (8.0 / math.pi) / params.aperture_f_number ** 2
    if params.lens_model == "general":
        amp_scale = amp_scale * lens_params[6]          # transmission
    amp0 = rad * float(np.float32(amp_scale))

    # density march: per-particle chief deltas, computed once for all
    # particles; they chunk like any other per-particle array
    deltas6 = None
    if vol is not None:
        inv_rot = as_f32(setup.inverse_rotation_matrix, dev)
        chief = _chief_geometry(xs, ys, zs, inv_rot, params.z_offset,
                                params.image_distance)
        if algorithm == 3 and march_substeps is None:
            # the substep count comes from the data (a Richardson estimate
            # on a subsample of the chief rays), once per scene
            key = (int(interpolation_scheme),
                   _scene_fingerprint(vol, setup, params, source))
            march_substeps = _substep_cache.get(key)
            if march_substeps is None:
                march_substeps = choose_substeps(
                    vol, *chief, interpolation_scheme=interpolation_scheme)
                _substep_cache[key] = march_substeps
        deltas6 = chief_deltas_dense(
            vol, *chief, algorithm=algorithm,
            interpolation_scheme=interpolation_scheme,
            substeps=march_substeps)

    render_fraction = 1.0 if params.lens_model == "apparent" else 0.75

    def render_chunk(sl):
        d6 = None if deltas6 is None else tuple(d[sl] for d in deltas6)
        A, AX, AY = fan_stats(xs[sl], ys[sl], zs[sl], amp0[sl], d6, x_lens,
                              y_lens, sc=sc, lens_model=params.lens_model,
                              mirror_x=params.implement_diffraction)
        # amplitude-weighted ray centroid: the spot centre and its anchor;
        # particles with no surviving ray get a far sentinel
        denom_a = A.clamp_min(1e-30)
        Xbar = AX / denom_a
        Ybar = AY / denom_a
        ok_p = A > 0
        far = torch.full_like(Xbar, -1e6)
        pred_col = torch.round(torch.where(ok_p, Xbar, far)).to(torch.int32)
        pred_row = torch.round(torch.where(ok_p, Ybar, far)).to(torch.int32)
        return particle_splat(
            Xbar, Ybar, A, pred_col, pred_row, nx=params.nx, ny=params.ny,
            diameter=params.diffraction_diameter, patch=patch,
            render_fraction=render_fraction)

    if particles_per_chunk is None or particles_per_chunk >= P:
        return render_chunk(slice(0, P))
    pc = max(1, int(particles_per_chunk))
    img = torch.zeros((params.ny, params.nx), dtype=torch.float32, device=dev)
    for s in range(0, P, pc):
        img += render_chunk(slice(s, min(s + pc, P)))     # in place
    return img
