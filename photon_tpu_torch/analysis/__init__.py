"""Ray-dump analysis and synthetic fields (the reference's C17 / C18)."""
from photon_tpu_torch.analysis.light_rays import (  # noqa: F401
    save_ray_data,
    load_ray_data,
    positions_to_pixels,
    dot_averaged_positions,
    ray_deflections,
    process_lightray_data,
)
from photon_tpu_torch.analysis.fields import (  # noqa: F401
    create_sine_field,
    create_sine_field_3d,
    create_gaussian_field,
    theoretical_deflection,
    density_gradient_for_displacement,
    density_noise_for_displacement_noise,
)
