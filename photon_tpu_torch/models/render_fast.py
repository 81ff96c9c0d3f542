"""Fast forward renderer: the (P particles, R rays) pipeline.

Counterpart of ``photon_tpu/models/render_fast.py``.  The renderer keeps the
*particle* structure of the problem explicit:

* density march: one chief ray per particle through the volume
  (``ops/march_dense_fused.py``), its deflection broadcast to the
  particle's ray fan (exact to the ~1 um lens-cone width); with
  ``chief_march=False`` every ray of the fan is marched on its own;
* ray generation -> lens -> sensor statistics: per-particle sums over the
  fan (``ops/fan.py``), no (P, R) array on the card;
* sensor: one erf spot per particle at its amplitude-weighted centroid
  (``ops/sensor_fast.py`` -> ``ops/splat.py``).

Where the fan kernel does not apply, the per-ray chain of the JAX package's
``render_chunk`` runs in PyTorch on (P, R) arrays (:func:`_ray_chain`): a
rotated camera with a density volume (the fan passes to the march's world
frame and back), a march of every ray, per-ray sensor position noise, and
the per-ray deposits (an erf spot a ray, or the bilinear sensor's
four-pixel deposit).  A rotated camera without a volume renders through
the fan kernel: the rotation enters the chain only where a volume is
marched.

Covered: the axis-aligned single-lens train with the 'apparent',
'thin-lens' or 'general' lens model, the erf diffraction or the bilinear
sensor, a camera rotated by less than 90 degrees, diffuse or Mie scattering
(the table collapsed to one factor a particle on the host,
:func:`mie_irradiance`), sensor position noise, and a density volume of any
slab size marched with any integrator of the menu under trilinear or cubic
B-spline interpolation.  A tilted or multi-element train and a camera
rotated by 90 degrees or more with a volume raise ``NotImplementedError``:
``pipeline.can_use_fast_renderer`` sends them to the exact renderer
(``models/render.py``).  With a device mesh (``parallel/shard.py``) each
rank renders its share of the particles and one all-reduce sums the images.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.device import DeviceLike, as_f32, resolve_device
from photon_tpu_torch.models.optics import CameraSetup
from photon_tpu_torch.models.render import RenderParams, _f32_rows
from photon_tpu_torch.models.scenes import LightfieldSource
from photon_tpu_torch.ops.fan import (FanConstants, FanScalars,
                                      fan_constants, fan_rays, fan_stats,
                                      fan_sums)
from photon_tpu_torch.ops.march_dense import (check_march_options,
                                              chief_deltas_dense,
                                              choose_substeps)
from photon_tpu_torch.ops.march_fast import apply_chief_deltas
from photon_tpu_torch.ops.sensor_fast import (bilinear_patch_splat,
                                              particle_splat, patch_splat)
from photon_tpu_torch.parallel.shard import (mesh_place, replicated,
                                             shard_bounds, sum_over)
from photon_tpu_torch.utils.profiling import span
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
                   scattering, inv_rot=None) -> np.ndarray:
    """(P,) float32 Mie irradiance factor of each particle.

    The per-ray scattering angles within a particle's ~1 um lens cone agree
    to ~1e-6 rad, so the table lookup collapses to one linear interpolation
    a particle, in angle, of its diameter's column, at the angle between its
    chief ray (toward the lens centre) and the beam vector; host float64
    numpy as in the JAX package (ref per-ray version:
    parallel_ray_tracing.cu:144-210).  The beam vector is in the world
    frame: ``inv_rot``, the camera's inverse rotation, turns the chief
    direction into it first and renormalises it, as the exact path does
    (``photon_tpu/models/render.py:138-143``).  ``inv_rot=None`` is the
    unrotated camera, whose frames agree.  ``scattering``: the dict of
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
    if inv_rot is None:
        cosang = beam[0] * ctx * cinv + beam[1] * cty * cinv \
            + beam[2] * (-cinv)
    else:
        w = np.asarray(inv_rot, np.float64) @ np.stack(
            [ctx * cinv, cty * cinv, -cinv])
        w = w / np.linalg.norm(w, axis=0)
        cosang = beam[0] * w[0] + beam[1] * w[1] + beam[2] * w[2]
    cosang = np.clip(cosang, -1.0, 1.0)
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


def _to_world(inv_rot, shift: float, px, py, pz, dx, dy, dz):
    """Camera frame -> the march's (world) frame: the z shift, then the
    camera's inverse rotation (nested lists of float32 values; None for an
    unrotated camera), componentwise in the JAX package's order."""
    pzs = pz - shift
    if inv_rot is None:
        return px, py, pzs, dx, dy, dz
    i = inv_rot
    return (i[0][0] * px + i[0][1] * py + i[0][2] * pzs,
            i[1][0] * px + i[1][1] * py + i[1][2] * pzs,
            i[2][0] * px + i[2][1] * py + i[2][2] * pzs,
            i[0][0] * dx + i[0][1] * dy + i[0][2] * dz,
            i[1][0] * dx + i[1][1] * dy + i[1][2] * dz,
            i[2][0] * dx + i[2][1] * dy + i[2][2] * dz)


def _to_camera(rot, shift: float, wx, wy, wz, wdx, wdy, wdz):
    """The march's frame -> the camera frame, :func:`_to_world` undone; a
    rotated direction is renormalised, as in the JAX package."""
    if rot is None:
        return wx, wy, wz + shift, wdx, wdy, wdz
    r = rot
    dx = r[0][0] * wdx + r[0][1] * wdy + r[0][2] * wdz
    dy = r[1][0] * wdx + r[1][1] * wdy + r[1][2] * wdz
    dz = r[2][0] * wdx + r[2][1] * wdy + r[2][2] * wdz
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return (r[0][0] * wx + r[0][1] * wy + r[0][2] * wz,
            r[1][0] * wx + r[1][1] * wy + r[1][2] * wz,
            r[2][0] * wx + r[2][1] * wy + r[2][2] * wz + shift,
            dx * inv, dy * inv, dz * inv)


def _centroids(A, AX, AY):
    """``(A, Xbar, Ybar, pred_col, pred_row)``: each particle's
    amplitude-weighted ray centroid, the spot's centre and its anchor;
    particles with no surviving ray get a far sentinel."""
    denom_a = A.clamp_min(1e-30)
    Xbar = AX / denom_a
    Ybar = AY / denom_a
    ok_p = A > 0
    far = torch.full_like(Xbar, -1e6)
    pred_col = torch.round(torch.where(ok_p, Xbar, far)).to(torch.int32)
    pred_row = torch.round(torch.where(ok_p, Ybar, far)).to(torch.int32)
    return A, Xbar, Ybar, pred_col, pred_row


def _ray_chain(xs, ys, zs, amp0, x_lens, y_lens, *, c: FanConstants,
               lens_model: str, mirror_x: bool, march=None, rot=None,
               inv_rot=None, sensor_noise=None):
    """The per-ray (P, R) chain of the JAX package's ``render_chunk``
    (``photon_tpu/models/render_fast.py:330-434``), in PyTorch.

    ``march``: a function of the six (P, R) ray components in the march's
    frame that returns them after the volume (the chief deltas, or each
    ray's own march), or None; the rays pass to that frame and back through
    ``rot`` / ``inv_rot`` (None: unrotated).  ``sensor_noise``: (2, P, R)
    displacements of the sensor-plane intersection, or None.  ``amp0``:
    (P,) amplitudes with every scalar factor folded.

    Returns ``((X, Y, amp), (A, Xbar, Ybar, pred_col, pred_row))``: the
    per-ray centres (unmasked: the deposits' ``safe`` drops culled rays)
    and amplitudes, and the per-particle sums and centroids, formed with
    culled rays' X and Y zeroed (the JAX chain sums ``amp * X`` over them).
    """
    world = None
    if march is not None:
        def world(*rays):
            return _to_camera(rot, c.shift,
                              *march(*_to_world(inv_rot, c.shift, *rays)))

    X, Y, cos2, valid = fan_rays(xs, ys, zs, x_lens, y_lens, c, lens_model,
                                 mirror_x, march=world,
                                 sensor_noise=sensor_noise)
    amp, sums = fan_sums(X, Y, cos2, valid, amp0)
    return (X, Y, amp), _centroids(*sums)


def _march_each_ray(vol, **march_kw):
    """A ``march`` for :func:`_ray_chain` that marches every ray of the fan
    through ``march_chief_fused`` (the march kernel on the card) and applies
    its own deltas."""
    def march(*rays):
        flat = [r.reshape(-1).contiguous() for r in rays]
        d6 = chief_deltas_dense(vol, *flat, **march_kw)
        return apply_chief_deltas(tuple(d.reshape(rays[0].shape) for d in d6),
                                  *rays)
    return march


def _chunk_normals(gen: torch.Generator, n: int, R: int) -> torch.Tensor:
    """(2, n, R) standard normals of one chunk's sensor noise."""
    return torch.randn((2, n, R), generator=gen, device=gen.device,
                       dtype=torch.float32)


def rank_seed(seed: int, rank: int) -> int:
    """The noise seed of a mesh rank: ``seed`` itself on rank 0 (so a mesh of
    one renders as no mesh), a stream of its own on every other rank."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), rank]).generate_state(
        1, np.uint64)[0])


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
                      noise_seed: Optional[int] = None,
                      dense_march: Optional[bool] = None,
                      march_substeps: Optional[int] = None,
                      device: DeviceLike = None,
                      _mesh_reduce: bool = True) -> torch.Tensor:
    """Render the raw (ny, nx) float32 image with the (P, R) pipeline.

    ``r1``/``r2``: (R,) lens-aperture samples shared by all particles
    (numpy arrays or tensors).  ``vol``: density volume on ``device``, or
    None for the reference image.  ``particles_per_chunk``: render the
    particles in chunks of this size and sum the chunk images; it bounds
    the (P, R) arrays of the per-ray chain and, with ``chief_march=False``,
    the rays a march takes.  ``scattering``: the Mie table dict of
    ``ops/mie.py`` (:func:`mie_irradiance`), or None for diffuse scattering.

    ``chief_march``: march one chief ray per particle and broadcast its
    deflection to the fan; False marches every ray (the JAX package marches
    them through its voxel-tube march, the port through the same gather
    march as the chief rays).  ``per_ray_splat``: deposit an erf spot per
    ray instead of one per particle at the amplitude-weighted centroid
    (forced on by position noise).  ``noise_seed``: seeds the sensor
    position noise (``cfg.seed`` when None); the chunks draw their normals
    in turn from one generator on ``device``.
    ``dense_march``: accepted for the JAX package's callers and without
    effect on the route.  There it chooses between three marches by the
    slab's size (None: dense up to 256 x 256, windowed above; True: dense,
    and an error above; False: the voxel-tube march); here one gather march
    (``ops/march_dense_fused.march_chief_fused``) serves every size, and its
    render is within the bound that package's tests hold its marches to each
    other (L1 2e-3 of the image sum; tests/test_torch_large_volume.py).
    ``device``: None is the CUDA device (raises without one); the tests
    pass "cpu".

    ``mesh``: a 1-D ``DeviceMesh`` of ``parallel.shard.make_mesh``, and
    every rank of it calls with the whole source.  Rank r of N renders the
    particles ``[r P // N, (r + 1) P // N)`` on the mesh's device (``device``
    may only name it) and returns the sum of the N images, on every rank;
    under autograd the volume's field enters as replicated, so its gradient
    is summed over the ranks too.  Algorithm 3 chooses its substeps from the
    whole source's chief rays, alike on every rank; the position noise draws
    ``noise_seed`` on rank 0 and a stream of its own on every other rank
    (:func:`rank_seed`).  ``_mesh_reduce=False`` returns the rank's own
    (1, ny, nx) image without the all-reduce (the scaling harness's
    reference).

    Spans (``utils.profiling.span``): ``render.image``, enclosing
    ``render.setup`` (the uploads, the lens samples' offsets and the fan's
    scalars), ``render.chief_march`` (the chief rays' deltas and the
    substep choice) and one ``render.chunk`` a chunk, the one-chunk render
    included.  ``render_image_fast.chunks`` counts the chunks rendered.
    """
    with span("render.image"):
        rank = size = None
        if mesh is not None:
            rank, size, mesh_dev = mesh_place(mesh)
            if device is not None and resolve_device(device) != mesh_dev:
                raise ValueError(f"device {device}: this rank of the mesh "
                                 f"renders on {mesh_dev}")
            device = mesh_dev
        dev = resolve_device(device)
        params = RenderParams.from_setup(cfg, setup, source)
        if not _axis_aligned(setup):
            raise NotImplementedError("fast path requires the axis-aligned "
                                      "single-lens train")
        if params.lens_model not in ("apparent", "thin-lens", "general"):
            raise ValueError(f"unknown lens_model {params.lens_model!r}")
        if vol is not None:
            if float(np.asarray(setup.inverse_rotation_matrix)[2, 2]) <= 0.0:
                # its rays travel upward in the march's frame: the chief march
                # enters a volume from above only
                raise NotImplementedError(
                    "the fast renderer marches rays that enter the volume "
                    "from above: render a camera rotated by 90 degrees or "
                    "more with a density volume through "
                    "models/render.render_image")
            check_march_options(algorithm, interpolation_scheme)
            if vol.field.device != dev:
                raise ValueError(f"volume on {vol.field.device}, render on "
                                 f"{dev}")
        elif dense_march:
            raise ValueError("dense_march=True requires a density volume")
        rotated = not np.allclose(setup.rotation_matrix, np.eye(3))
        per_ray_splat = per_ray_splat or params.add_pos_noise
        per_ray_march = vol is not None and not chief_march
        # the fan kernel's route: diffraction, one spot a particle, and the
        # camera frame equal to the march's frame up to the z shift
        chain = (per_ray_splat or not params.implement_diffraction
                 or per_ray_march or (rotated and vol is not None))
        if patch is None:
            # per-ray deposits keep the JAX package's conservative side: the
            # rays' spread around the anchor depends on the scene (defocus,
            # position noise)
            patch = (auto_patch(params) if params.implement_diffraction
                     and not per_ray_splat else 12)

        with span("render.setup"):
            xs = as_f32(source.x, dev)
            ys = as_f32(source.y, dev)
            zs = as_f32(source.z, dev)
            rad = source.radiance
            if scattering is not None:
                # the Mie factor folds into the radiance, before amp0's scale
                rad = np.asarray(rad, np.float32) * mie_irradiance(
                    params.image_distance, source, scattering,
                    setup.inverse_rotation_matrix if rotated else None)
            rad = as_f32(rad, dev)
            r1 = as_f32(r1, dev)
            r2 = as_f32(r2, dev)
            P, R = xs.shape[0], r1.shape[0]
            if mesh is not None:
                if P < size:
                    raise ValueError(f"{P} particles over a mesh of {size}: "
                                     "every rank needs one")
                if vol is not None and vol.field.requires_grad \
                        and torch.is_grad_enabled():
                    vol = vol._replace(field=replicated(mesh, vol.field))

            st = setup.elements
            lens_params = (float(setup.z_lens), float(st.pitch[0]),
                           float(st.vertex_distance[0]),
                           float(st.front_surface_radius[0]),
                           float(st.back_surface_radius[0]),
                           float(st.refractive_index[0]),
                           float(st.transmission_ratio[0]))
            sc = fan_scalars(params, lens_params)

            # lens-aperture sample offsets, shared by all particles
            # (ref: :104-130)
            cone = params.ray_cone_pitch_ratio * params.lens_pitch
            x_lens = cone * r1 * torch.cos(2.0 * math.pi * r2)
            y_lens = cone * r1 * torch.sin(2.0 * math.pi * r2)
            if R == 1:
                x_lens = torch.zeros_like(x_lens)
                y_lens = torch.zeros_like(y_lens)
            # 8/pi is the erf spot's normalisation: the bilinear deposit has
            # none
            amp_scale = ((8.0 / math.pi) if params.implement_diffraction
                         else 1.0) / params.aperture_f_number ** 2
            if params.lens_model == "general":
                amp_scale = amp_scale * lens_params[6]          # transmission
            amp0 = rad * float(np.float32(amp_scale))
            whole_xyz = (xs, ys, zs)
            own = slice(None)
            if mesh is not None:
                own = slice(*shard_bounds(P, rank, size))
                xs, ys, zs, amp0 = xs[own], ys[own], zs[own], amp0[own]

        # density march: per-particle chief deltas, computed once for all
        # particles; they chunk like any other per-particle array
        deltas6 = None
        march_kw = dict(algorithm=algorithm,
                        interpolation_scheme=interpolation_scheme,
                        substeps=march_substeps)
        if vol is not None and chief_march:
            with span("render.chief_march"):
                inv_rot = as_f32(setup.inverse_rotation_matrix, dev)
                # the whole source's chief rays: on a mesh every rank probes
                # them all for the substeps and marches its own
                chief = _chief_geometry(*whole_xyz, inv_rot, params.z_offset,
                                        params.image_distance)
                if algorithm == 3 and march_substeps is None:
                    # the substep count comes from the data (a Richardson
                    # estimate on a subsample of the chief rays), once per
                    # scene
                    key = (int(interpolation_scheme),
                           _scene_fingerprint(vol, setup, params, source))
                    march_kw["substeps"] = _substep_cache.get(key)
                    if march_kw["substeps"] is None:
                        march_kw["substeps"] = choose_substeps(
                            vol, *chief,
                            interpolation_scheme=interpolation_scheme)
                        _substep_cache[key] = march_kw["substeps"]
                deltas6 = chief_deltas_dense(
                    vol, *(c[own].contiguous() for c in chief), **march_kw)

        render_fraction = 1.0 if params.lens_model == "apparent" else 0.75
        splat_kw = dict(nx=params.nx, ny=params.ny, patch=patch)
        chain_kw = dict(c=fan_constants(sc), lens_model=params.lens_model,
                        mirror_x=params.implement_diffraction)
        if rotated:
            chain_kw.update(rot=_f32_rows(setup.rotation_matrix),
                            inv_rot=_f32_rows(setup.inverse_rotation_matrix))
        gen = noise_scale = None
        if params.add_pos_noise:
            gen = torch.Generator(device=dev)
            seed = int(cfg.seed if noise_seed is None else noise_seed)
            gen.manual_seed(seed if mesh is None else rank_seed(seed, rank))
            # N(0, 1) * std * pixel_pitch on the sensor-plane intersection
            noise_scale = float(np.float32(params.pos_noise_std
                                           * params.pixel_pitch))

        def render_chunk(sl, normals=None):
            """The image of the particles ``sl``; ``normals``: their (2, n, R)
            standard normals of the sensor noise, or None without noise."""
            d6 = None if deltas6 is None else tuple(d[sl] for d in deltas6)
            if not chain:
                sums = fan_stats(xs[sl], ys[sl], zs[sl], amp0[sl], d6, x_lens,
                                 y_lens, sc=sc, lens_model=params.lens_model,
                                 mirror_x=params.implement_diffraction)
                A, Xbar, Ybar, pred_col, pred_row = _centroids(*sums)
                return particle_splat(
                    Xbar, Ybar, A, pred_col, pred_row,
                    diameter=params.diffraction_diameter,
                    render_fraction=render_fraction, **splat_kw)
            march = (_march_each_ray(vol, **march_kw) if per_ray_march
                     else None if d6 is None
                     else functools.partial(apply_chief_deltas, d6))
            (X, Y, amp), (A, Xbar, Ybar, pred_col, pred_row) = _ray_chain(
                xs[sl], ys[sl], zs[sl], amp0[sl], x_lens, y_lens, march=march,
                sensor_noise=(None if normals is None
                              else normals * noise_scale),
                **chain_kw)
            if not params.implement_diffraction:
                return bilinear_patch_splat(X, Y, amp, pred_col, pred_row,
                                            **splat_kw)
            if per_ray_splat:
                return patch_splat(X, Y, amp, pred_col, pred_row,
                                   diameter=params.diffraction_diameter,
                                   **splat_kw)
            return particle_splat(Xbar, Ybar, A, pred_col, pred_row,
                                  diameter=params.diffraction_diameter,
                                  render_fraction=render_fraction, **splat_kw)

        def chunk_image(s, e):
            render_image_fast.chunks += 1
            with span("render.chunk"):
                return render_chunk(slice(s, e), None if gen is None
                                    else _chunk_normals(gen, e - s, R))

        n = xs.shape[0]                          # the rank's own on a mesh
        if particles_per_chunk is None or particles_per_chunk >= n:
            img = chunk_image(0, n)
        else:
            pc = max(1, int(particles_per_chunk))
            img = torch.zeros((params.ny, params.nx), dtype=torch.float32,
                              device=dev)
            for s in range(0, n, pc):
                img += chunk_image(s, min(s + pc, n))         # in place
        if mesh is None:
            return img
        return sum_over(mesh, img) if _mesh_reduce else img[None]


render_image_fast.chunks = 0
