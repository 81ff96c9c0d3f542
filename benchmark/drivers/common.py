"""Inputs that more than one driver makes: the program's configuration and
the reference's, from one configuration file; the BOS scene's particles and
lens samples; the bench's Gaussian density grids.

The particles come from the frozen copy of the program's scene builder in
``benchmark/reference/scenes.py`` and the Gaussian from ``chip_smoke.py``'s
``bench_volume_512`` (the JAX package's ``bench.py`` large volume), so that
the harness makes the inputs and hands the same to both sides.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed of its own for each ``salt``, drawn from ``seed``."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), *salt])
               .generate_state(1, np.uint64)[0] >> 1)


def program_config(doc: dict, seed: int):
    from photon_tpu_torch.config import SimulationConfig
    cfg = SimulationConfig.from_dict(copy.deepcopy(doc["simulation"]))
    cfg.seed = int(seed)
    return cfg


def reference_config(doc: dict, seed: int):
    from benchmark.reference.config import SimulationConfig
    cfg = SimulationConfig.from_dict(copy.deepcopy(doc["simulation"]))
    cfg.seed = int(seed)
    return cfg


def lens_samples(seed: int, n: int):
    """(r1, r2): the lens-aperture samples shared by every particle, from a
    CPU generator (as ``photon_tpu_torch.pipeline._lens_sample_pair``)."""
    import torch
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    r1 = torch.rand(n, generator=gen, dtype=torch.float32)
    r2 = torch.rand(n, generator=gen, dtype=torch.float32)
    return r1, r2


@dataclass
class BosInputs:
    """What the BOS cells hand to both sides."""
    ref_cfg: object
    ref_setup: object
    ref_source: object
    r1: object
    r2: object


def bos_inputs(doc: dict, seed: int) -> BosInputs:
    from benchmark.reference.optics import camera_setup
    from benchmark.reference.scenes import bos_source
    cfg = reference_config(doc, seed)
    setup = camera_setup(cfg)
    source, _, _ = bos_source(cfg, setup, np.random.default_rng(
        sub_seed(seed, 1)))
    r1, r2 = lens_samples(sub_seed(seed, 2),
                          int(cfg.bos_pattern.lightray_number_per_particle))
    return BosInputs(cfg, setup, source, r1, r2)


def program_source(src):
    """The program's ``LightfieldSource`` holding the harness's arrays."""
    from photon_tpu_torch.models.scenes import LightfieldSource
    return LightfieldSource(
        x=src.x, y=src.y, z=src.z, radiance=src.radiance,
        diameter_index=src.diameter_index, z_offset=src.z_offset,
        object_distance=src.object_distance,
        lightray_number_per_particle=src.lightray_number_per_particle)


@dataclass
class Grid:
    """The bench volume's grid: sizes (W, H, D), spacings and origin in um
    (the origin before the reference's 750e3 shift), and its axes."""
    sizes: tuple
    spacings: list
    origin: list
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray


def bench_grid(doc: dict, setup) -> Grid:
    v = doc["volume"]
    w, h, d = (int(n) for n in v["sizes"])
    x = np.linspace(*v["x_um"], w)
    y = np.linspace(*v["y_um"], h)
    z0, z1 = v["z_before_object_um"]
    z = np.linspace(setup.object_distance - z0, setup.object_distance - z1, d)
    return Grid((w, h, d), [x[1] - x[0], y[1] - y[0], z[1] - z[0]],
                [x[0], y[0], z[0]], x, y, z)


def gaussian_rho(grid: Grid, doc: dict, dev, centre=(0.0, 0.0, 0.0),
                 amplitude=None):
    """(W, H, D) float32 rho = rho_0 + a g(x) g(y) g(z) on the device, with
    Gaussian factors of sigma ``sigma_of_extent`` of each extent, centred
    on the grid's middle moved by ``centre`` (um)."""
    import torch
    v = doc["volume"]
    amp = float(v["amplitude"] if amplitude is None else amplitude)
    f = float(v["sigma_of_extent"])

    def g(axis, shift):
        mid = 0.5 * (axis.min() + axis.max()) + shift
        sig = f * (axis.max() - axis.min())
        return torch.as_tensor(np.exp(-((axis - mid) / sig) ** 2 / 2.0),
                               dtype=torch.float32, device=dev)

    gx, gy, gz = g(grid.x, centre[0]), g(grid.y, centre[1]), g(grid.z,
                                                                centre[2])
    rho = gx[:, None, None] * gy[None, :, None] * gz[None, None, :]
    return rho.mul_(amp).add_(float(v["rho_0"]))
