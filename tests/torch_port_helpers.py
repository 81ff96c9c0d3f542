"""Shared helpers of the tests/test_torch_*.py parity tests.

State crosses from the JAX package to the port as numpy arrays and plain
dicts (``photon_tpu_torch.compat.from_reference``); the unpacking on the
JAX side happens here.
"""
import dataclasses
import json

import numpy as np

from photon_tpu_torch.compat import from_reference


def port_volume(jax_vol, device="cpu"):
    state = {k: (np.asarray(v) if hasattr(v, "shape") else float(v))
             for k, v in jax_vol._asdict().items()}
    return from_reference(volume=state, device=device)["volume"]


def port_source(jax_source):
    return from_reference(source=dataclasses.asdict(jax_source),
                          device="cpu")["source"]


def port_config(jax_cfg):
    return from_reference(config=json.loads(jax_cfg.to_json()),
                          device="cpu")["config"]


def small_bos_scene(n_dots=4, rays=8, sensor=64, n=8, device="cpu"):
    """A small BOS scene of the port alone: (cfg, setup, source, r1, r2,
    rho, vol), the density a ramp along x on an n^3 grid between the dot
    plane and the lens, its volume built on ``device``."""
    import torch

    from photon_tpu_torch.config import default_config
    from photon_tpu_torch.models.optics import camera_setup
    from photon_tpu_torch.models.scenes import bos_source
    from photon_tpu_torch.volume import build_density_volume

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = sensor
    cfg.camera_design.y_pixel_number = sensor
    bp = cfg.bos_pattern
    bp.grid_point_number = n_dots
    bp.particle_number_per_grid_point = 6
    bp.lightray_number_per_particle = rays
    m = cfg.lens_design.focal_length / (cfg.lens_design.object_distance
                                        - cfg.lens_design.focal_length)
    half = 0.7 * sensor * cfg.camera_design.pixel_pitch / 2.0 / m
    bp.X_Min, bp.X_Max, bp.Y_Min, bp.Y_Max = -half, half, -half, half
    setup = camera_setup(cfg)
    source, _, _ = bos_source(cfg, setup, np.random.default_rng(4))
    gen = torch.Generator().manual_seed(9)
    r1 = torch.rand(rays, generator=gen)
    r2 = torch.rand(rays, generator=gen)
    x = np.linspace(-2e5, 2e5, n)
    z = np.linspace(setup.object_distance * 0.4,
                    setup.object_distance * 0.9, n)
    rho = (1.225 + 4.0 * (x[:, None, None] - x.min()) / np.ptp(x)
           * np.ones((1, n, n))).astype(np.float32)
    geometry = ([x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]])
    vol = build_density_volume(rho, *geometry, device=device)
    return cfg, setup, source, r1, r2, rho, vol


def rel_l1(a, b):
    """L1 distance of two images relative to the reference's sum."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


def fan_inputs(lens_model, p=70, r=24, seed=0):
    """A small fan scene: the scalars, the four particle columns, the six
    march deltas and the lens rows, as float32 numpy arrays; the last
    particles lie beyond the sensor's field of view."""
    from photon_tpu_torch.config import default_config
    from photon_tpu_torch.models.optics import camera_setup
    from photon_tpu_torch.models.render import RenderParams
    from photon_tpu_torch.models.render_fast import fan_scalars
    from photon_tpu_torch.models.scenes import bos_source

    cfg = default_config("bos")
    cfg.lens_design.lens_model = lens_model
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
    cfg.bos_pattern.grid_point_number = 2
    cfg.bos_pattern.particle_number_per_grid_point = 2
    setup = camera_setup(cfg)
    src, *_ = bos_source(cfg, setup, np.random.default_rng(1))
    params = RenderParams.from_setup(cfg, setup, src)
    st = setup.elements
    lens_params = (float(setup.z_lens), float(st.pitch[0]),
                   float(st.vertex_distance[0]),
                   float(st.front_surface_radius[0]),
                   float(st.back_surface_radius[0]),
                   float(st.refractive_index[0]), 1.0)
    sc = fan_scalars(params, lens_params)

    rng = np.random.default_rng(seed)
    m = setup.magnification
    half_x = 128 * 17.0 / 2.0 / m
    half_y = 96 * 17.0 / 2.0 / m
    # the last particles lie beyond the sensor's field of view
    xs = rng.uniform(-half_x, half_x, p)
    ys = rng.uniform(-half_y, half_y, p)
    xs[-6:] = 1.6 * half_x
    ys[-3:] = -1.4 * half_y
    zs = np.full(p, setup.z_object)
    amp0 = rng.uniform(0.5, 2.0, p)
    cone = params.ray_cone_pitch_ratio * params.lens_pitch
    r1, r2 = rng.random(r), rng.random(r)
    x_lens = cone * r1 * np.cos(2 * np.pi * r2)
    y_lens = cone * r1 * np.sin(2 * np.pi * r2)
    z_exit = np.full(p, 0.4 * setup.object_distance - 750e3)
    deltas = [z_exit, rng.normal(0, 30.0, p), rng.normal(0, 30.0, p),
              rng.normal(0, 2e-5, p), rng.normal(0, 2e-5, p),
              rng.normal(0, 1e-9, p)]
    f32 = lambda a: np.asarray(a, np.float32)
    return (sc, [f32(a) for a in (xs, ys, zs, amp0)],
            [f32(d) for d in deltas], f32(x_lens), f32(y_lens))
