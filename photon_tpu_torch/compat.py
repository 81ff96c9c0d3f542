"""Carrying state across from the JAX package.

:func:`from_reference` takes what ``photon_tpu`` produced *as numpy arrays
and plain dicts* and returns the port's objects on a given device, so that
both packages can compute the same thing from the same state.  It imports
nothing of ``photon_tpu``: the caller (a parity test) does the unpacking on
the JAX side, e.g. ``{k: np.asarray(v) for k, v in vol._asdict().items()}``,
``dataclasses.asdict(source)``, ``json.loads(cfg.to_json())``; the Mie
table dict of ``photon_tpu.ops.mie.create_mie_scattering_data`` is numpy
already.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from photon_tpu_torch.config import SimulationConfig
from photon_tpu_torch.device import DeviceLike, as_f32, resolve_device
from photon_tpu_torch.models.scenes import LightfieldSource
from photon_tpu_torch.volume import DensityVolume

_VOLUME_FIELDS = ("field", "min_bound", "max_bound", "grid_spacing",
                  "data_min", "step_size", "max_step_size")


def volume_from_reference(volume: Mapping[str, Any],
                          device: DeviceLike = None) -> DensityVolume:
    """A ``DensityVolume``'s seven fields (arrays and floats) -> the port's."""
    missing = [k for k in _VOLUME_FIELDS if k not in volume]
    if missing:
        raise KeyError(f"volume state lacks {missing}")
    dev = resolve_device(device)
    field = np.asarray(volume["field"], dtype=np.float32)
    if field.ndim != 4 or field.shape[-1] != 4:
        raise ValueError(f"field must be (D, H, W, 4), got {field.shape}")
    return DensityVolume(
        field=as_f32(field, dev),
        min_bound=np.asarray(volume["min_bound"], dtype=np.float32).ravel(),
        max_bound=np.asarray(volume["max_bound"], dtype=np.float32).ravel(),
        grid_spacing=np.asarray(volume["grid_spacing"], dtype=np.float32).ravel(),
        data_min=float(volume["data_min"]),
        step_size=float(volume["step_size"]),
        max_step_size=float(volume["max_step_size"]))


def source_from_reference(source: Mapping[str, Any]) -> LightfieldSource:
    """A ``LightfieldSource``'s arrays and scalars -> the port's (host-side
    numpy, like the JAX package's; the renderer moves it to its device)."""
    return LightfieldSource(
        x=np.asarray(source["x"], dtype=np.float32),
        y=np.asarray(source["y"], dtype=np.float32),
        z=np.asarray(source["z"], dtype=np.float32),
        radiance=np.asarray(source["radiance"], dtype=np.float64),
        diameter_index=np.asarray(source["diameter_index"], dtype=np.int32),
        z_offset=float(source["z_offset"]),
        object_distance=float(source["object_distance"]),
        lightray_number_per_particle=int(
            source["lightray_number_per_particle"]),
        source_point_number=int(source.get("source_point_number", 10000)))


# the Mie table's arrays that the renderer and piv_source read, and their
# host dtypes (ops/mie.create_mie_scattering_data)
_SCATTERING_DTYPES = {
    "scattering_angle": np.float64,
    "scattering_irradiance": np.float64,
    "beam_propogation_vector": np.float64,
    "particle_diameter_index_distribution": np.int32,
}


def scattering_from_reference(scattering: Mapping[str, Any]) -> Dict[str, Any]:
    """The Mie table dict -> the port's: its four arrays the renderer and
    ``piv_source`` read, as host-side numpy of the port's dtypes."""
    missing = [k for k in _SCATTERING_DTYPES if k not in scattering]
    if missing:
        raise KeyError(f"scattering lacks {missing}")
    return {k: np.asarray(scattering[k], dtype=dt)
            for k, dt in _SCATTERING_DTYPES.items()}


def from_reference(*, config: Optional[Mapping[str, Any]] = None,
                   volume: Optional[Mapping[str, Any]] = None,
                   source: Optional[Mapping[str, Any]] = None,
                   scattering: Optional[Mapping[str, Any]] = None,
                   r1=None, r2=None,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """State of the JAX package -> the port's objects on ``device``.

    Args:
      config: ``SimulationConfig.to_json``'s dict.
      volume: the seven fields of a ``DensityVolume`` (numpy arrays, floats).
      source: a ``LightfieldSource``'s arrays and scalars.
      scattering: the Mie table dict (``create_mie_scattering_data``).
      r1, r2: (R,) lens-aperture samples.
      device: None is the CUDA device (raises without one).

    Returns a dict with a key for every argument given: ``config``
    (SimulationConfig), ``volume`` (DensityVolume, its field on the device),
    ``source`` (LightfieldSource), ``scattering`` (dict of numpy arrays, for
    ``render_image_fast(scattering=...)``), ``r1``/``r2`` (float32 tensors).
    """
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    if config is not None:
        out["config"] = SimulationConfig.from_dict(dict(config))
    if volume is not None:
        out["volume"] = volume_from_reference(volume, dev)
    if source is not None:
        out["source"] = source_from_reference(source)
    if scattering is not None:
        out["scattering"] = scattering_from_reference(scattering)
    if r1 is not None:
        out["r1"] = as_f32(np.asarray(r1), dev)
    if r2 is not None:
        out["r2"] = as_f32(np.asarray(r2), dev)
    return out
