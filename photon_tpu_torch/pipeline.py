"""Simulation entry points: end-to-end PIV / BOS / calibration images.

Counterpart of ``photon_tpu/pipeline.py`` (the reference's orchestration
layer, run_simulation_02.py:1725-2106): builds the optical system,
generates the scene, renders (the reference + density-gradient pair for
BOS, a frame sequence for PIV, a plane sequence for calibration),
post-processes and writes TIFF/raw artifacts plus the parameter/position
sidecars.  :func:`can_use_fast_renderer` routes each case, as in the JAX
package, to the fast renderer (``models/render_fast.py``) or to the
exact-semantics renderer (``models/render.py``).  ``save_lightrays``
writes the reference's ray dumps (final positions and directions, and the
per-step trajectories of the first rays), traced chunk by chunk through the
exact renderer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.device import DeviceLike, resolve_device
from photon_tpu_torch.models.optics import CameraSetup, camera_setup
from photon_tpu_torch.device import as_f32
from photon_tpu_torch.models.render import render_image, render_rays
from photon_tpu_torch.models.render_fast import (_axis_aligned,
                                                 render_image_fast)
from photon_tpu_torch.models.scenes import (LightfieldSource, bos_source,
                                            calibration_source, piv_source)
from photon_tpu_torch.ops.march import make_march_fn, march_rays
from photon_tpu_torch.ops.march_dense import bspline_prefilter
from photon_tpu_torch.ops.mie import create_mie_scattering_data
from photon_tpu_torch.postprocess import postprocess
from photon_tpu_torch.utils.profiling import PhaseTimer
from photon_tpu_torch.utils.rng import lens_samples, reference_lens_samples
from photon_tpu_torch.utils.tiff_io import write_tiff16
from photon_tpu_torch.volume import load_density_volume


@dataclass
class SimulationResult:
    """Artifacts of one run: quantized + raw images and scene metadata."""

    images: Dict[str, np.ndarray]          # name -> uint16 image
    raw_images: Dict[str, np.ndarray]      # name -> float32 image
    setup: CameraSetup
    sources: Dict[str, LightfieldSource]
    dot_positions: Optional[Dict[str, np.ndarray]] = None
    timer: Optional[PhaseTimer] = None     # seconds per phase of the run


def _lens_sample_pair(cfg: SimulationConfig, n_rays: int):
    """Per-ray lens-aperture samples, shared by all source points.

    (analogue of generate_random_numbers_for_lightrays,
    ref: run_simulation_02.py:1699-1722; with ``reference_lens_rng`` the
    exact glibc srand(10) stream of the CUDA host is reproduced.)  The
    native draw uses a CPU ``torch.Generator`` seeded with ``cfg.seed``, so
    the samples do not depend on the device that renders.
    """
    if cfg.reference_lens_rng:
        return reference_lens_samples(int(n_rays))
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(cfg.seed))
    return lens_samples(gen, int(n_rays))


def can_use_fast_renderer(cfg: SimulationConfig, setup: CameraSetup,
                          vol=None) -> bool:
    """Whether the fast (P, R) pipeline is the route for this config.

    The same routing rule as the JAX package: the axis-aligned single-lens
    train without gradient-index noise, dispersion or absorbance, and a
    camera rotated by less than 90 degrees when a volume is marched.
    Everything else belongs to the exact-semantics path.
    """
    dg = cfg.density_gradients
    if not _axis_aligned(setup) or dg.add_ngrad_noise:
        return False
    if vol is not None and \
            float(np.asarray(setup.inverse_rotation_matrix)[2, 2]) <= 0.0:
        return False
    if setup.lens_model == "general":
        st = setup.elements
        # the fast thick lens has no dispersion/absorbance terms
        if np.isfinite(float(st.abbe_number[0])) \
                or float(st.absorbance_rate[0]) != 0.0:
            return False
    return True


def _ray_budget(cfg: SimulationConfig) -> int:
    """The config's lightray_process_number for the active scene section:
    the in-flight ray budget that sizes the particle chunks."""
    section = {"bos": cfg.bos_pattern, "piv": cfg.particle_field,
               "cal": cfg.calibration_grid}.get(cfg.simulation_type)
    if section is None:
        return 2_000_000
    return int(section.lightray_process_number)


def _render(cfg: SimulationConfig, setup: CameraSetup, source, r1, r2,
            vol=None, scattering=None, rays_per_chunk: Optional[int] = None,
            noise_seed: Optional[int] = None, fast: Optional[bool] = None,
            device: DeviceLike = None) -> torch.Tensor:
    """Render one image, chunked to the ray budget, through the route
    ``fast`` (True: the fast renderer; False: the exact renderer with
    ``vol`` marched, if given; None: :func:`can_use_fast_renderer` of this
    image).  ``noise_seed`` seeds the sensor position noise (``cfg.seed``
    when None)."""
    if fast is None:
        fast = can_use_fast_renderer(cfg, setup, vol=vol)
    if rays_per_chunk is None:
        rays_per_chunk = _ray_budget(cfg)
    dg = cfg.density_gradients
    if not fast:
        march_fn = None if vol is None else make_march_fn(
            vol, algorithm=int(dg.ray_tracing_algorithm),
            interpolation_scheme=int(dg.interpolation_scheme),
            add_ngrad_noise=bool(dg.add_ngrad_noise),
            ngrad_noise_std=float(dg.ngrad_noise_std), seed=int(cfg.seed))
        return render_image(cfg, setup, source, r1, r2, march_fn=march_fn,
                            scattering=scattering,
                            rays_per_chunk=rays_per_chunk,
                            noise_seed=noise_seed, device=device)
    R = int(source.lightray_number_per_particle)
    P = source.num_particles
    ppc = max(1, rays_per_chunk // max(R, 1))
    return render_image_fast(
        cfg, setup, source, r1, r2, vol=vol,
        algorithm=int(dg.ray_tracing_algorithm),
        interpolation_scheme=int(dg.interpolation_scheme),
        particles_per_chunk=ppc if ppc < P else None, scattering=scattering,
        noise_seed=noise_seed, device=device)


def _z_shift_kw(cfg: SimulationConfig) -> dict:
    """NRRD z-origin shift override (see DensityGradients.nrrd_z_origin_shift)."""
    s = cfg.density_gradients.nrrd_z_origin_shift
    return {} if s is None else {"z_origin_shift": float(s)}


def _load_volume(cfg: SimulationConfig, dev: torch.device):
    return load_density_volume(
        cfg.density_gradients.density_gradient_filename,
        gladstone_dale=cfg.density_gradients.gladstone_dale, device=dev,
        **_z_shift_kw(cfg))


def run_bos(cfg: SimulationConfig,
            rng: Optional[np.random.Generator] = None,
            rays_per_chunk: Optional[int] = None,
            verbose: bool = False,
            device: DeviceLike = None) -> SimulationResult:
    """Render the BOS image pair: im1 (no gradients) + im2 (with gradients).

    (ref: run_simulation_02.py:1976-2106)  ``device``: None is the CUDA
    device (raises without one); "cpu" runs the plain versions.
    """
    dev = resolve_device(device)
    timer = PhaseTimer(device=dev)
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    with timer.phase("scene"):
        setup = camera_setup(cfg)
        source, dot_x, dot_y = bos_source(cfg, setup, rng)
        r1, r2 = _lens_sample_pair(cfg, source.lightray_number_per_particle)

    vol = None
    if bool(cfg.density_gradients.density_gradient_filename):
        with timer.phase("volume"):
            vol = _load_volume(cfg, dev)

    # one route for both images, chosen with the volume: a camera rotated by
    # 90 degrees or more renders im1 on the exact path too, as in the JAX
    # package
    fast = can_use_fast_renderer(cfg, setup, vol=vol)
    images, raws = {}, {}
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(int(cfg.seed) + 7)
    for im_idx, (name, gradients) in enumerate(
            (("bos_pattern_image_1", False), ("bos_pattern_image_2", True))):
        # im1 always renders without gradients, im2 with them — regardless
        # of the config flag (ref: run_simulation_02.py:2034, 2064)
        use_vol = vol if gradients else None
        with timer.phase(f"render:{name}", num_rays=source.num_rays):
            raw = _render(cfg, setup, source, r1, r2, vol=use_vol,
                          rays_per_chunk=rays_per_chunk,
                          noise_seed=cfg.seed + im_idx, fast=fast,
                          device=dev)
        with timer.phase("postprocess"):
            I, I_raw = postprocess(cfg, raw, generator=noise_gen)
        images[name], raws[name] = I, I_raw

        if cfg.output_data.save_lightrays:
            with timer.phase("save_lightrays"):
                _save_lightrays(cfg, setup, source, r1, r2, use_vol,
                                "im2" if gradients else "im1", dev)

    if verbose:
        print(timer.report())
    return SimulationResult(images=images, raw_images=raws, setup=setup,
                            sources={"bos": source},
                            dot_positions={"x": dot_x, "y": dot_y},
                            timer=timer)


def _save_lightrays(cfg: SimulationConfig, setup: CameraSetup, source,
                    r1, r2, vol, tag: str, dev: torch.device) -> None:
    """Write the final ray dumps as the reference does, one file of float32
    (x, y, z) rows per chunk of the ray budget: ``pos_%04d.bin`` under
    ``light-ray-positions/<tag>`` and ``dir_%04d.bin`` under
    ``light-ray-directions/<tag>`` (ref: parallel_ray_tracing.cu
    :3561-3670), the first ``num_lightrays_save`` rays (0: all), marched
    without noise.  With ``save_intermediate_ray_data`` and a volume, the
    same march records the first ``num_intermediate_positions_save``
    iterations of those rays into ``intermediate_{pos,dir}_0000.bin``,
    (n_save, S, 3) float32 in the march's (world) frame (:3613-3670).

    Rays are independent, so only the particles whose rays are saved are
    traced, a chunk at a time, and each chunk's files are written as it
    is done: the same files as one trace of the whole source (the JAX
    package's way, photon_tpu/pipeline.py:246), in the memory of one
    chunk.  Position noise draws each chunk's normals in turn from a
    generator seeded with 0 (the JAX package's draws cannot be
    repeated)."""
    od = cfg.output_data
    base = od.image_directory or "."
    pos_dir = od.lightray_positions_filepath or os.path.join(
        base, "light-ray-positions", tag)
    dir_dir = od.lightray_directions_filepath or os.path.join(
        base, "light-ray-directions", tag)
    os.makedirs(pos_dir, exist_ok=True)
    os.makedirs(dir_dir, exist_ok=True)
    R = max(1, int(source.lightray_number_per_particle))
    n_all = source.num_particles * R
    n_save = min(int(od.num_lightrays_save) or n_all, n_all)
    ppc = max(1, _ray_budget(cfg) // R)
    chunk_rays = ppc * R
    record = bool(od.save_intermediate_ray_data) and vol is not None
    dg = cfg.density_gradients
    march_kw = dict(algorithm=int(dg.ray_tracing_algorithm),
                    interpolation_scheme=int(dg.interpolation_scheme))
    if vol is not None:
        field = vol.field
        if march_kw["interpolation_scheme"] == 2:
            field = bspline_prefilter(field)
        march_kw["field_flat"] = field.reshape(-1, 4)
    gen = None
    if cfg.density_gradients.add_pos_noise:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    r1, r2 = as_f32(r1, dev), as_f32(r2, dev)
    with contextlib.ExitStack() as files:
        if record:
            inter = [files.enter_context(open(os.path.join(
                d, f"intermediate_{k}_0000.bin"), "wb"))
                for d, k in ((pos_dir, "pos"), (dir_dir, "dir"))]
        for c in range(max(1, -(-n_save // chunk_rays))):
            take = max(0, min(chunk_rays, n_save - c * chunk_rays))
            sl = slice(c * ppc, c * ppc + -(-take // R))
            sub = dataclasses.replace(
                source, x=source.x[sl], y=source.y[sl], z=source.z[sl],
                radiance=source.radiance[sl],
                diameter_index=source.diameter_index[sl])
            recorded = []

            def march(rays_w, take=take, recorded=recorded):
                if not record:
                    return march_rays(vol, rays_w, **march_kw)
                out, rec = march_rays(
                    vol, rays_w, record_steps=int(
                        od.num_intermediate_positions_save),
                    record_rays=take, **march_kw)
                recorded.append(rec)
                return out

            pos = np.zeros((0, 3), np.float32)
            dirs = pos
            if take:
                normals = None if gen is None else torch.randn(
                    (sub.num_particles * R, 2), generator=gen, device=dev,
                    dtype=torch.float32)
                rays = render_rays(cfg, setup, sub, r1, r2,
                                   march_fn=None if vol is None else march,
                                   normals=normals, device=dev)
                pos = rays.pos[:take].cpu().numpy()
                dirs = rays.dir[:take].cpu().numpy()
            pos.tofile(os.path.join(pos_dir, f"pos_{c:04d}.bin"))
            dirs.tofile(os.path.join(dir_dir, f"dir_{c:04d}.bin"))
            if recorded:
                for f, a in zip(inter, recorded[0]):
                    f.write(a.cpu().numpy().tobytes())


def run_piv(cfg: SimulationConfig,
            rng: Optional[np.random.Generator] = None,
            rays_per_chunk: Optional[int] = None,
            verbose: bool = False,
            device: DeviceLike = None) -> SimulationResult:
    """Render the PIV frame sequence (ref: run_simulation_02.py:1773-1879).

    One numpy ``rng`` draws, in the JAX package's order, the Mie table's
    diameter indices and then each frame's particles; the density volume
    (``simulate_density_gradients``) bends every frame.  ``device``: None
    is the CUDA device (raises without one); "cpu" runs the plain versions.
    """
    dev = resolve_device(device)
    timer = PhaseTimer(device=dev)
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    pf = cfg.particle_field
    with timer.phase("scene"):
        setup = camera_setup(cfg)
    scattering = diameter_idx = None
    if pf.perform_mie_scattering:
        with timer.phase("mie"):
            scattering = create_mie_scattering_data(cfg, rng)
        diameter_idx = scattering["particle_diameter_index_distribution"]
    with timer.phase("scene"):
        r1, r2 = _lens_sample_pair(cfg, pf.lightray_number_per_particle)

    vol = None
    if cfg.density_gradients.simulate_density_gradients:
        with timer.phase("volume"):
            vol = _load_volume(cfg, dev)

    images, raws, sources = {}, {}, {}
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(int(cfg.seed) + 7)
    for frame_index in pf.frame_vector:
        name = f"particle_image_frame_{int(frame_index):04d}"
        with timer.phase("scene"):
            source = piv_source(cfg, setup, int(frame_index),
                                diameter_index_distribution=diameter_idx,
                                rng=rng)
        with timer.phase(f"render:{name}", num_rays=source.num_rays):
            raw = _render(cfg, setup, source, r1, r2, vol=vol,
                          scattering=scattering,
                          rays_per_chunk=rays_per_chunk,
                          noise_seed=cfg.seed + int(frame_index), device=dev)
        with timer.phase("postprocess"):
            images[name], raws[name] = postprocess(cfg, raw,
                                                   generator=noise_gen)
        sources[name] = source

    if verbose:
        print(timer.report())
    return SimulationResult(images=images, raw_images=raws, setup=setup,
                            sources=sources, timer=timer)


def run_cal(cfg: SimulationConfig,
            rng: Optional[np.random.Generator] = None,
            rays_per_chunk: Optional[int] = None,
            verbose: bool = False,
            device: DeviceLike = None) -> SimulationResult:
    """Render one image per calibration plane
    (ref: run_simulation_02.py:1881-1974).  ``device`` as in run_piv."""
    dev = resolve_device(device)
    timer = PhaseTimer(device=dev)
    if rng is None:
        rng = np.random.default_rng(cfg.seed)
    cg = cfg.calibration_grid
    with timer.phase("scene"):
        setup = camera_setup(cfg)
        r1, r2 = _lens_sample_pair(cfg, cg.lightray_number_per_particle)

    images, raws, sources = {}, {}, {}
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(int(cfg.seed) + 7)
    for plane in range(int(cg.calibration_plane_number)):
        name = f"calibration_image_plane_{plane + 1:04d}"
        with timer.phase("scene"):
            source = calibration_source(cfg, setup, plane, rng)
        with timer.phase(f"render:{name}", num_rays=source.num_rays):
            raw = _render(cfg, setup, source, r1, r2,
                          rays_per_chunk=rays_per_chunk, device=dev)
        with timer.phase("postprocess"):
            images[name], raws[name] = postprocess(cfg, raw,
                                                   generator=noise_gen)
        sources[name] = source

    if verbose:
        print(timer.report())
    return SimulationResult(images=images, raw_images=raws, setup=setup,
                            sources=sources, timer=timer)


def run_simulation(cfg: SimulationConfig, **kw) -> SimulationResult:
    """Dispatch on simulation_type (ref: run_simulation_02.py:1773, 1881, 1976)."""
    if cfg.simulation_type == "bos":
        return run_bos(cfg, **kw)
    if cfg.simulation_type == "piv":
        return run_piv(cfg, **kw)
    if cfg.simulation_type == "cal":
        return run_cal(cfg, **kw)
    raise ValueError(f"unknown simulation_type {cfg.simulation_type!r}")


def save_result(cfg: SimulationConfig, result: SimulationResult,
                out_dir: Optional[str] = None) -> List[str]:
    """Write TIFF + raw artifacts and parameter sidecars.

    Directory layout mirrors the reference: ``tif/`` and ``raw/``
    subdirectories plus ``parameters``/``positions`` metadata
    (ref: run_simulation_02.py:1764-1771, 2048-2106).  Parameters and
    positions are written BOTH as JSON and as reference-format ``.mat``
    sidecars (``parameters.mat``/``positions.mat``), so the reference's
    analysis tooling (light_ray_processing.py:539-551 starts by loading
    ``parameters.mat``) can consume an output directory.
    """
    import scipy.io as sio
    out_dir = out_dir or cfg.output_data.image_directory or "."
    tif_dir = os.path.join(out_dir, "tif")
    raw_dir = os.path.join(out_dir, "raw")
    os.makedirs(tif_dir, exist_ok=True)
    os.makedirs(raw_dir, exist_ok=True)
    written = []
    for name, img in result.images.items():
        p = os.path.join(tif_dir, name + ".tif")
        write_tiff16(p, img)
        written.append(p)
    for name, raw in result.raw_images.items():
        p = os.path.join(raw_dir, name + ".bin")
        raw.astype(np.float32).tofile(p)
        written.append(p)
    p = os.path.join(out_dir, "parameters.json")
    cfg.to_json(p)
    written.append(p)
    p = os.path.join(out_dir, "parameters.mat")
    cfg.to_mat(p)
    written.append(p)
    if result.dot_positions is not None:
        p = os.path.join(out_dir, "positions.json")
        with open(p, "w") as f:
            json.dump({k: np.asarray(v).tolist()
                       for k, v in result.dot_positions.items()}, f)
        written.append(p)
        # reference layout: positions.mat holds the dot grid as (N, 1)
        # column vectors under x/y (ref sample-data bos/positions.mat)
        p = os.path.join(out_dir, "positions.mat")
        sio.savemat(p, {k: np.asarray(v, np.float64).reshape(-1, 1)
                        for k, v in result.dot_positions.items()})
        written.append(p)
    return written
