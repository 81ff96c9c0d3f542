"""Frozen copy of ``photon_tpu_torch/config.py``, kept beside the benchmark so that a later
change to the program does not move the yardstick; only its imports
differ.

Typed configuration for photon_tpu_torch simulations (own copy of the
JAX package's config module: same fields, same JSON and ``.mat`` layout).

Mirrors the field inventory of the reference's nested parameter dict
(``python_codes/create_simulation_parameters.py:4-258``) as frozen
dataclasses, with JSON round-tripping and a loader for the reference's
MATLAB ``.mat`` parameter files so existing photon configs keep working.

Units follow the reference: distances in microns, angles in radians,
densities in kg/m^3, the Gladstone-Dale constant in m^3/kg.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Section dataclasses
# ---------------------------------------------------------------------------


@dataclass
class LensDesign:
    """Lens design parameters (ref: create_simulation_parameters.py:14-31)."""

    focal_length: float = 105e3              # microns
    aperture_f_number: float = 8.0
    object_distance: float = 700e3           # front principal plane -> focal plane
    lens_radius_of_curvature: float = 100000.0e3
    lens_model: str = "general"              # 'general' | 'thin-lens' | 'apparent'
    ray_cone_pitch_ratio: float = 1e-4       # fraction of lens pitch used by the ray cone
    object_distance_buffer: Optional[float] = None   # extra defocus distance
    perturbation: Optional[float] = None     # fractional sensor-plane shift


@dataclass
class CameraDesign:
    """Camera/sensor parameters (ref: create_simulation_parameters.py:33-60)."""

    pixel_pitch: float = 17.0                # microns
    x_pixel_number: int = 1024
    y_pixel_number: int = 1024
    pixel_bit_depth: int = 10
    pixel_gain: float = 25.0                 # dB
    x_camera_angle: float = 0.0              # radians
    y_camera_angle: float = 0.0
    image_noise: float = 0.0                 # gaussian std as a fraction (x100 counts)
    intensity_rescaling: bool = True
    implement_diffraction: bool = True
    diffraction_diameter: float = 3.0        # pixels


@dataclass
class ParticleField:
    """PIV particle-field parameters (ref: create_simulation_parameters.py:62-142)."""

    generate_particle_field_images: bool = True
    load_particle_data: bool = False
    data_directory: str = ""
    data_filename_prefix: str = "particle_data_frame"
    frame_vector: Tuple[int, ...] = (1, 2)
    particle_number: int = 500_000
    lightray_number_per_particle: int = 100
    lightray_process_number: int = 1_000_000
    gaussian_beam_fwhm: float = 0.73e3       # microns
    perform_mie_scattering: bool = True
    medium_refractive_index: float = 1.3330
    particle_refractive_index: float = 1.5700
    particle_diameter_mean: float = 27.0     # microns
    particle_diameter_std: float = 5.0
    particle_diameter_number: int = 27
    particle_diameter_cdf_threshhold: float = 0.01
    mie_scattering_angle_number: int = 128
    beam_propogation_vector: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    beam_wavelength: float = 0.532           # microns
    # optional extent overrides (ref: run_simulation_02.py:912-940 defaults)
    X_Min: float = -7.5e4
    X_Max: float = +7.5e4
    Y_Min: float = -7.5e4
    Y_Max: float = +7.5e4
    Z_Min: float = -7.5e3
    Z_Max: float = +7.5e3
    particle_depth: Optional[float] = None   # z for single-particle scenes
    lightray_radiance: Optional[float] = None  # overrides irradiance constant


@dataclass
class CalibrationGrid:
    """Calibration-target parameters (ref: create_simulation_parameters.py:144-177)."""

    generate_calibration_grid_images: bool = True
    grid_point_diameter: float = 3.2e3
    x_grid_point_spacing: float = 15e3
    y_grid_point_spacing: float = 15e3
    x_grid_point_number: int = 11
    y_grid_point_number: int = 11
    calibration_plane_number: int = 7
    calibration_plane_spacing: float = 1e3
    particle_number_per_grid_point: int = 1000
    lightray_number_per_particle: int = 500
    lightray_process_number: int = 1_000_000


@dataclass
class BosPattern:
    """BOS dot-pattern parameters (ref: create_simulation_parameters.py:179-220)."""

    generate_bos_pattern_images: bool = True
    grid_point_diameter: float = 6.0e2
    x_grid_point_number: int = 150
    y_grid_point_number: int = 150
    grid_point_number: int = 1000
    particle_number_per_grid_point: int = 100
    lightray_number_per_particle: int = 500
    lightray_process_number: int = 1_000_000
    X_Min: float = -7.5e4
    X_Max: float = +7.5e4
    Y_Min: float = -7.5e4
    Y_Max: float = +7.5e4
    num_lightrays_save: int = 1_000_000
    dot_overlap: bool = False
    dot_distribution: str = "random"         # 'random' | 'regular'
    dot_spacing: float = 6.0                 # pixels (regular distribution)
    lightray_radiance: Optional[float] = None


@dataclass
class DensityGradients:
    """Refractive-index volume parameters (ref: create_simulation_parameters.py:223-236)."""

    simulate_density_gradients: bool = False
    density_gradient_filename: str = ""
    ray_tracing_algorithm: int = 2           # 1 euler | 2 rk4 | 3 rk45 | 4 adams-bashforth
    gladstone_dale: float = 0.225e-3         # m^3/kg
    rho_0: float = 1.225                     # kg/m^3
    add_pos_noise: bool = False
    pos_noise_std: float = 0.0               # fraction of a pixel
    add_ngrad_noise: bool = False
    ngrad_noise_std: float = 0.0             # 1/um
    interpolation_scheme: int = 1            # 1 trilinear | 2 tricubic B-spline
    # NRRD z-origin shift into the marcher frame.  The reference
    # hardcodes 750e3 (trace_rays_through_density_gradients.h:1704) but
    # carries a commented-out `+ z_offset` variant on the same line
    # while shifting RAYS by z_offset + 750e3 (parallel_ray_tracing.cu:
    # 2045) — for lenses with large vertex offsets the two conventions
    # place the volume differently relative to the dot plane.  None =
    # the shipped 750e3; set to 750e3 + setup.z_offset to reproduce the
    # commented variant (used by the general-lens sample-scene tests).
    nrrd_z_origin_shift: Optional[float] = None


@dataclass
class OutputData:
    """Output/artifact parameters (ref: create_simulation_parameters.py:238-257)."""

    image_directory: str = ""
    crop_image: bool = False
    r_crop: int = 0
    c_crop: int = 0
    save_lightrays: bool = False
    num_lightrays_save: int = 100
    save_intermediate_ray_data: bool = False
    num_intermediate_positions_save: int = 100
    lightray_positions_filepath: str = ""
    lightray_directions_filepath: str = ""


@dataclass
class SimulationConfig:
    """Top-level simulation configuration.

    ``simulation_type`` selects which scene section is active, matching the
    reference's branching in ``run_simulation_02.py:1773-2106``.
    """

    simulation_type: str = "bos"             # 'piv' | 'cal' | 'bos'
    lens_design: LensDesign = field(default_factory=LensDesign)
    camera_design: CameraDesign = field(default_factory=CameraDesign)
    particle_field: Optional[ParticleField] = None
    calibration_grid: Optional[CalibrationGrid] = None
    bos_pattern: Optional[BosPattern] = None
    density_gradients: DensityGradients = field(default_factory=DensityGradients)
    output_data: OutputData = field(default_factory=OutputData)
    seed: int = 1105                         # scene/lens-sample RNG seed
    # reproduce the reference's exact lens-sample stream (glibc srand(10),
    # ref: parallel_ray_tracing.cu:3228) instead of torch.Generator draws
    reference_lens_rng: bool = False

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.to_dict(), indent=2, default=_json_default)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationConfig":
        return _config_from_dict(d)

    @classmethod
    def from_json(cls, path: str) -> "SimulationConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_mat(cls, path: str) -> "SimulationConfig":
        """Load a reference-format MATLAB parameter file.

        Mirrors the mat_struct -> dict normalization of
        ``batch_run_simulation.py:80-115`` (including the int -> float
        coercion quirks), then maps fields onto the dataclasses.
        """
        import scipy.io as sio

        raw = sio.loadmat(path, struct_as_record=False, squeeze_me=True)
        d = {k: _mat_to_dict(v) for k, v in raw.items() if not k.startswith("__")}
        # Some files nest everything under 'simulation_parameters'.
        if "simulation_parameters" in d:
            d = d["simulation_parameters"]
        return cls.from_dict(d)

    def to_mat(self, path: str) -> None:
        """Write a reference-format MATLAB parameter file.

        The field inventory matches the reference's nested parameter
        struct (the dataclass fields use the reference's names), nested
        under ``simulation_parameters`` like the sidecars the reference
        writes next to every image (ref: run_simulation_02.py:1874-1879,
        2094-2106) and its analysis tools load back
        (light_ray_processing.py:539-551).  Round-trips through
        :meth:`from_mat`.
        """
        import scipy.io as sio

        def clean(v):
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items() if x is not None}
            if isinstance(v, bool):
                return int(v)
            return v

        sio.savemat(path, {"simulation_parameters": clean(self.to_dict())},
                    long_field_names=True)


def default_config(simulation_type: str) -> SimulationConfig:
    """Build the default parameter set for a workload type.

    Equivalent to ``create_simulation_parameters(simulation_type)``
    (ref: create_simulation_parameters.py:4-258).
    """
    cfg = SimulationConfig(simulation_type=simulation_type)
    if simulation_type == "piv":
        cfg.particle_field = ParticleField()
    elif simulation_type == "cal":
        cfg.calibration_grid = CalibrationGrid()
    elif simulation_type == "bos":
        cfg.bos_pattern = BosPattern()
    else:
        raise ValueError(f"unknown simulation_type {simulation_type!r}")
    return cfg


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _mat_to_dict(obj):
    """Recursively convert scipy mat_struct objects to plain dicts/values."""
    if hasattr(obj, "_fieldnames"):
        return {k: _mat_to_dict(getattr(obj, k)) for k in obj._fieldnames}
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        return [_mat_to_dict(v) for v in obj]
    return obj


_SECTIONS = {
    "lens_design": LensDesign,
    "camera_design": CameraDesign,
    "particle_field": ParticleField,
    "calibration_grid": CalibrationGrid,
    "bos_pattern": BosPattern,
    "density_gradients": DensityGradients,
    "output_data": OutputData,
}

_BOOL_FIELDS = {
    "intensity_rescaling", "implement_diffraction", "generate_particle_field_images",
    "load_particle_data", "perform_mie_scattering", "generate_calibration_grid_images",
    "generate_bos_pattern_images", "dot_overlap", "simulate_density_gradients",
    "add_pos_noise", "add_ngrad_noise", "crop_image", "save_lightrays",
    "save_intermediate_ray_data",
}


def _coerce(cls, name: str, value):
    """Coerce a raw (.mat / json) value to the dataclass field's type."""
    ftypes = {f.name: f.type for f in dataclasses.fields(cls)}
    t = ftypes.get(name)
    if value is None:
        return None
    if name in _BOOL_FIELDS:
        return bool(value)
    if t in ("int", int):
        return int(value)
    if t in ("float", float, "Optional[float]", Optional[float]):
        return float(value)
    if t in ("str", str):
        return str(value)
    if isinstance(value, np.ndarray):
        return tuple(np.asarray(value).ravel().tolist())
    if isinstance(value, (list,)):
        return tuple(value)
    return value


def _section_from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k in names:
            kwargs[k] = _coerce(cls, k, v)
        # silently tolerate unknown keys (the reference probes many optionals)
    return cls(**kwargs)


def _config_from_dict(d: dict) -> SimulationConfig:
    cfg = SimulationConfig(simulation_type=str(d.get("simulation_type", "bos")))
    for key, cls in _SECTIONS.items():
        if key in d and d[key] is not None and isinstance(d[key], dict):
            setattr(cfg, key, _section_from_dict(cls, d[key]))
    if "seed" in d:
        cfg.seed = int(d["seed"])
    if "reference_lens_rng" in d:
        cfg.reference_lens_rng = bool(d["reference_lens_rng"])
    return cfg
