"""Simulation entry points: end-to-end BOS image generation.

Counterpart of ``photon_tpu/pipeline.py`` (the reference's orchestration
layer, run_simulation_02.py:1725-2106): builds the optical system,
generates the scene, renders the reference + density-gradient image pair,
post-processes and writes TIFF/raw artifacts plus the parameter/position
sidecars.  This slice drives the BOS pair through the fast renderer; PIV,
calibration, ray dumps and the exact renderer raise ``NotImplementedError``
naming the ROADMAP.md item that brings them.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.device import DeviceLike, resolve_device
from photon_tpu_torch.models.optics import CameraSetup, camera_setup
from photon_tpu_torch.models.render_fast import (_axis_aligned,
                                                 render_image_fast)
from photon_tpu_torch.models.scenes import LightfieldSource, bos_source
from photon_tpu_torch.postprocess import postprocess
from photon_tpu_torch.roadmap import CONFIGS, EXACT_PATH, later
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
            vol=None, rays_per_chunk: Optional[int] = None,
            device: DeviceLike = None) -> torch.Tensor:
    """Render through the fast renderer, chunked to the ray budget."""
    if not can_use_fast_renderer(cfg, setup, vol=vol):
        raise later("a configuration outside the fast renderer (tilted or "
                    "multi-element train, gradient-index noise, dispersion,"
                    " absorbance, camera rotated by 90 degrees or more)",
                    EXACT_PATH)
    if rays_per_chunk is None:
        rays_per_chunk = _ray_budget(cfg)
    R = int(source.lightray_number_per_particle)
    P = source.num_particles
    ppc = max(1, rays_per_chunk // max(R, 1))
    return render_image_fast(
        cfg, setup, source, r1, r2, vol=vol,
        algorithm=int(cfg.density_gradients.ray_tracing_algorithm),
        interpolation_scheme=int(cfg.density_gradients.interpolation_scheme),
        particles_per_chunk=ppc if ppc < P else None, device=device)


def _z_shift_kw(cfg: SimulationConfig) -> dict:
    """NRRD z-origin shift override (see DensityGradients.nrrd_z_origin_shift)."""
    s = cfg.density_gradients.nrrd_z_origin_shift
    return {} if s is None else {"z_origin_shift": float(s)}


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
    if cfg.output_data.save_lightrays:
        raise later("save_lightrays (final ray dumps)", EXACT_PATH)
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
            vol = load_density_volume(
                cfg.density_gradients.density_gradient_filename,
                gladstone_dale=cfg.density_gradients.gladstone_dale,
                device=dev, **_z_shift_kw(cfg))

    images, raws = {}, {}
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(int(cfg.seed) + 7)
    for name, gradients in (("bos_pattern_image_1", False),
                            ("bos_pattern_image_2", True)):
        # im1 always renders without gradients, im2 with them — regardless
        # of the config flag (ref: run_simulation_02.py:2034, 2064)
        use_vol = vol if gradients else None
        with timer.phase(f"render:{name}", num_rays=source.num_rays):
            raw = _render(cfg, setup, source, r1, r2, vol=use_vol,
                          rays_per_chunk=rays_per_chunk, device=dev)
        with timer.phase("postprocess"):
            I, I_raw = postprocess(cfg, raw, generator=noise_gen)
        images[name], raws[name] = I, I_raw

    if verbose:
        print(timer.report())
    return SimulationResult(images=images, raw_images=raws, setup=setup,
                            sources={"bos": source},
                            dot_positions={"x": dot_x, "y": dot_y},
                            timer=timer)


def run_simulation(cfg: SimulationConfig, **kw) -> SimulationResult:
    """Dispatch on simulation_type (ref: run_simulation_02.py:1773, 1881, 1976)."""
    if cfg.simulation_type == "bos":
        return run_bos(cfg, **kw)
    if cfg.simulation_type in ("piv", "cal"):
        raise later(f"simulation_type {cfg.simulation_type!r}",
                    CONFIGS)
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
