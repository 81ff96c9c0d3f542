"""Frozen copy of ``photon_tpu_torch/postprocess.py``, kept beside the benchmark so that a later
change to the program does not move the yardstick; only its imports
differ.

Image post-processing: noise, gain, quantization, cropping.

Counterpart of ``photon_tpu/postprocess.py`` (the reference's post-render
stage, perform_ray_tracing_03.py:2193-2259): additive Gaussian noise scaled
by ``image_noise * 100`` counts, clipping at zero, pixel gain
``10^(dB/20)``, normalization to ``2^bit_depth - 1`` by the image maximum,
integer rounding, and re-expansion to the full 16-bit range.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.config import SimulationConfig


def add_image_noise(image: torch.Tensor, noise_fraction: float,
                    generator: torch.Generator) -> torch.Tensor:
    """Additive Gaussian noise with std = noise_fraction * 100 counts,
    drawn from ``generator`` (on its device, then moved to the image's).

    (ref: perform_ray_tracing_03.py:2197-2209)
    """
    if noise_fraction <= 0.0:
        return image
    noise = torch.randn(image.shape, generator=generator, dtype=image.dtype,
                        device=generator.device).to(image.device)
    return image + noise * (noise_fraction * 100.0)


def quantize(image: torch.Tensor, pixel_gain_db: float, pixel_bit_depth: int,
             intensity_rescaling: bool = True) -> np.ndarray:
    """Gain + bit-depth quantization to uint16 counts (a numpy array).

    (ref: perform_ray_tracing_03.py:2211-2247)
    """
    zero = torch.zeros_like(image)
    image = torch.where(image < 0.0, zero, image)
    if intensity_rescaling:
        image = torch.where(torch.isfinite(image), image, zero)
        image = image * 10.0 ** (pixel_gain_db / 20.0)
        maxval = image.max()
        levels = 2.0 ** pixel_bit_depth - 1.0
        image = torch.where(maxval > 0.0, levels * image / maxval, image)
        image = torch.round(image)
        image = image * (2.0 ** 16 - 1.0) / levels
    # truncating conversion, saturated to the 16-bit range
    counts = image.clamp(0.0, 65535.0).to(torch.int32)
    return counts.cpu().numpy().astype(np.uint16)


def crop(image: np.ndarray, r_crop: int, c_crop: int) -> np.ndarray:
    """Center crop (ref: perform_ray_tracing_03.py:2250-2259)."""
    nr, nc = image.shape
    return image[nr // 2 - r_crop // 2: nr // 2 + r_crop // 2 - 1,
                 nc // 2 - c_crop // 2: nc // 2 + c_crop // 2 - 1]


def postprocess(cfg: SimulationConfig, raw_image: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Full post-processing chain -> (quantized uint16, raw float32), numpy.

    Returns the same (I, I_raw) pair as the reference's
    ``perform_ray_tracing_03`` tail (:2189-2291).
    """
    cd = cfg.camera_design
    raw = raw_image.to(torch.float32)
    if cd.image_noise > 0.0:
        if generator is None:
            generator = torch.Generator(device=raw.device)
            generator.manual_seed(cfg.seed)
        raw = add_image_noise(raw, cd.image_noise, generator)
    I = quantize(raw, cd.pixel_gain, cd.pixel_bit_depth,
                 cd.intensity_rescaling)
    I_raw = raw.cpu().numpy().astype(np.float32)
    if cfg.output_data.crop_image:
        I = crop(I, cfg.output_data.r_crop, cfg.output_data.c_crop)
        I_raw = crop(I_raw, cfg.output_data.r_crop, cfg.output_data.c_crop)
    return I, I_raw
