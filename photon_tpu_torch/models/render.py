"""Static parameters of the forward pass.

Counterpart of ``photon_tpu/models/render.py``, of which this slice needs
only :class:`RenderParams`.  The exact-semantics renderer (``render_image``,
``render_rays``) arrives with the exact path (ROADMAP.md, "the exact path").
"""
from __future__ import annotations

from dataclasses import dataclass

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.models.optics import CameraSetup
from photon_tpu_torch.models.scenes import LightfieldSource


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
