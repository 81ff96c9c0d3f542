"""Port vs JAX: per-particle fan statistics (plain PyTorch version on the
CPU against photon_tpu.ops.fan_pallas.fan_stats in interpret mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.ops.fan_pallas import FanScalars as JaxFanScalars
from photon_tpu.ops.fan_pallas import fan_stats as jax_fan_stats
from photon_tpu_torch.config import default_config
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render import RenderParams
from photon_tpu_torch.models.render_fast import fan_scalars
from photon_tpu_torch.models.scenes import bos_source
from photon_tpu_torch.ops.fan import fan_stats, fan_stats_plain


def _inputs(lens_model, p=70, r=24, seed=0):
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


@pytest.mark.parametrize("with_deltas", [False, True])
@pytest.mark.parametrize("lens_model", ["general", "apparent", "thin-lens"])
def test_fan_stats_match_jax(lens_model, with_deltas):
    sc, cols, deltas, x_lens, y_lens = _inputs(lens_model)
    ref = jax_fan_stats(
        *(jnp.asarray(c) for c in cols),
        tuple(jnp.asarray(d) for d in deltas) if with_deltas else None,
        jnp.asarray(x_lens), jnp.asarray(y_lens),
        sc=JaxFanScalars(**sc._asdict()), lens_model=lens_model,
        mirror_x=True, interpret=True)
    got = fan_stats(
        *(torch.from_numpy(c) for c in cols),
        tuple(torch.from_numpy(d) for d in deltas) if with_deltas else None,
        torch.from_numpy(x_lens), torch.from_numpy(y_lens),
        sc=sc, lens_model=lens_model, mirror_x=True)
    A_ref = np.asarray(ref[0])
    assert (A_ref > 0).sum() >= 40 and (A_ref == 0).sum() >= 3
    # budget of the JAX package's own kernel-vs-chain test
    # (tests/test_fan_pallas.py): relative error < 5e-4 of the largest
    # value.  The thick lens forms beta^2 - 4 gamma from coordinates of
    # 1e5..1e8 um in f32 and the two sides round it differently (rsqrt
    # against 1/sqrt, fusion), which is where most of the budget goes.
    for name, g, r in zip(("A", "AX", "AY"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        rel = np.abs(g - r).max() / np.abs(r).max()
        assert rel < 5e-4, (name, rel)
    # the same particles are culled on both sides
    np.testing.assert_array_equal(got[0].numpy() > 0, A_ref > 0)


def test_fan_plain_chunking_and_mirror():
    sc, cols, deltas, x_lens, y_lens = _inputs("general")
    t = lambda a: torch.from_numpy(a)
    kw = dict(sc=sc, lens_model="general")
    d6 = tuple(t(d) for d in deltas)
    whole = fan_stats_plain(*(t(c) for c in cols), d6, t(x_lens), t(y_lens),
                            **kw)
    parts = fan_stats_plain(*(t(c) for c in cols), d6, t(x_lens), t(y_lens),
                            particles_per_chunk=16, **kw)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # without the mirror the x centroid reflects about the frame centre
    plain = fan_stats_plain(*(t(c) for c in cols), d6, t(x_lens), t(y_lens),
                            mirror_x=False, **kw)
    A, AX = whole[0].numpy(), whole[1].numpy()
    ok = (A > 0) & (plain[0].numpy() > 0)
    xbar_m = AX[ok] / A[ok]
    xbar = plain[1].numpy()[ok] / plain[0].numpy()[ok]
    np.testing.assert_allclose(xbar_m + 0.5, (sc.nx - 1) - (xbar + 0.5),
                               atol=1e-2)
