"""Port vs JAX: the exact-semantics renderer (``models/render.py``) and the
pipeline's routing to it, on the CPU, on the same seeded inputs.

Ray generation (diffuse and Mie), ``trace_chunk`` for the three lens models,
``render_image`` with and without a volume, the bilinear sensor and injected
position noise; ``run_bos`` and ``run_piv`` with the reference sample scene's
camera (rotated by 5 pi / 6 about y) and a volume that its world-frame rays
cross, both images through the exact path; and tests/test_fast.py's
fast-against-exact pairs through the port's two renderers.

Tolerances.  Images are held to the JAX package's budget between two
renderers of one scene (tests/test_fast.py): L1 within 1e-3 of the sum.
Beside it every pixel is held on a common scale, the image's maximum, to
the goldens' rtol 2e-3: the thick lens's discriminant cancels from ~1e16
and the JAX package's CPU ``sqrt`` is not always correctly rounded
(tests/test_torch_exact_ops.py), which moves dim edge pixels by more than
2e-3 of their own value.
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import photon_tpu.models.render as jrender
from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.ops.march import make_march_fn as jax_make_march_fn
from photon_tpu.pipeline import run_bos as jax_run_bos
from photon_tpu.pipeline import run_piv as jax_run_piv
from photon_tpu.utils.rng import lens_samples as jax_lens_samples
from photon_tpu_torch import pipeline
from photon_tpu_torch.models import render
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.ops.march import make_march_fn
from photon_tpu_torch.utils.nrrd_io import write_nrrd
from tests.test_bos_pipeline import bos_case, gradient_volume_between
from tests.test_fast import _scene as fast_scene
from tests.test_render import point_source, tiny_cfg
from tests.torch_port_helpers import (port_config, port_source, port_volume,
                                      rel_l1)

_L1 = 1e-3
SAMPLE_ANGLE = 5 * np.pi / 6        # tests/test_sample_scene.py


def hold_image(got, ref, l1=_L1):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and ref.sum() > 0
    d = rel_l1(got, ref)
    worst = float(np.abs(got - ref).max() / ref.max())
    print(f"    L1 {d:.3g} of the sum; largest pixel difference {worst:.3g} "
          f"of the maximum")
    assert d < l1, d
    assert worst <= 2e-3, worst


def _chunk_arrays(src, r1, r2):
    return [np.asarray(src.x, np.float32), np.asarray(src.y, np.float32),
            np.asarray(src.z, np.float32),
            np.asarray(src.radiance, np.float32),
            np.asarray(src.diameter_index, np.int32),
            np.asarray(r1, np.float32), np.asarray(r2, np.float32)]


# ---------------------------------------------------------------------------
# ray generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mie", [False, True])
def test_generate_rays_matches_jax(mie):
    """Diffuse rays, and Mie rays whose radiance follows the angle between
    the world-frame ray (a rotated camera) and the beam: positions and
    directions to 1e-6, radiances to 1e-5 (arccos's last bits)."""
    cfg = tiny_cfg("general")
    cfg.camera_design.x_camera_angle = 0.3
    cfg.camera_design.y_camera_angle = -0.2
    setup = jax_camera_setup(cfg)
    tsetup = camera_setup(port_config(cfg))
    rng = np.random.default_rng(12)
    P, R = 9, 20
    src = point_source(cfg, setup, rays=R)
    src = src.__class__(**{**src.__dict__,
                           "x": rng.uniform(-2e3, 2e3, P).astype(np.float32),
                           "y": rng.uniform(-2e3, 2e3, P).astype(np.float32),
                           "z": np.full(P, setup.z_object, np.float32),
                           "radiance": rng.uniform(1, 3, P),
                           "diameter_index": rng.integers(0, 5, P)
                           .astype(np.int32)})
    arrays = _chunk_arrays(src, rng.random(R), rng.random(R))
    jparams = jrender.RenderParams.from_setup(cfg, setup, src)
    tparams = render.RenderParams.from_setup(port_config(cfg), tsetup,
                                             port_source(src))
    kw_j, kw_t = {}, {}
    if mie:
        angles = np.linspace(0.0, np.pi, 40).astype(np.float32)
        table = rng.uniform(0.1, 2.0, (40, 5)).astype(np.float32)
        inv = np.asarray(tsetup.inverse_rotation_matrix, np.float32)
        beam = np.array([0.0, 1.0, 0.0], np.float32)
        kw_j = dict(scattering=(jnp.asarray(angles), jnp.asarray(table)),
                    inverse_rotation_matrix=inv,
                    beam_propagation_vector=beam)
        kw_t = dict(scattering=(torch.tensor(angles), torch.tensor(table)),
                    inverse_rotation_matrix=inv,
                    beam_propagation_vector=beam)
    ref = jrender.generate_rays(*(jnp.asarray(a) for a in arrays), jparams,
                                **kw_j)
    got = render.generate_rays(*(torch.tensor(a) for a in arrays), tparams,
                               **kw_t)
    for name, g, r, tol in zip(ref._fields, got, ref, (1e-6, 1e-6, 0, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=tol,
                                   atol=tol, err_msg=name)
    if mie:
        # the table, not the source radiance alone, sets the rays' radiance
        diffuse = render.generate_rays(*(torch.tensor(a) for a in arrays),
                                       tparams).radiance.numpy()
        assert np.abs(got.radiance.numpy() - diffuse).max() \
            > 1e-2 * diffuse.max()


# ---------------------------------------------------------------------------
# trace_chunk and render_image
# ---------------------------------------------------------------------------

def _point_scene(lens_model, diffraction=True, n=5, rays=64):
    """tests/test_render.py's tiny scene (64^2 sensor) with ``n`` points:
    the JAX config, both packages' camera setups, the JAX source, r1, r2."""
    cfg = tiny_cfg(lens_model, diffraction=diffraction)
    setup = jax_camera_setup(cfg)
    rng = np.random.default_rng(20)
    src = point_source(cfg, setup, rays=rays)
    m = setup.magnification
    half = 20 * cfg.camera_design.pixel_pitch / m
    src = src.__class__(**{**src.__dict__,
                           "x": rng.uniform(-half, half, n).astype(np.float32),
                           "y": rng.uniform(-half, half, n).astype(np.float32),
                           "z": np.full(n, setup.z_object, np.float32),
                           "radiance": rng.uniform(5, 10, n),
                           "diameter_index": np.zeros(n, np.int32)})
    r1, r2 = (np.asarray(a) for a in jax_lens_samples(jax.random.key(0),
                                                      rays))
    return cfg, (setup, camera_setup(port_config(cfg))), src, r1, r2


@pytest.mark.parametrize("lens_model,diffraction", [
    ("apparent", True), ("thin-lens", True), ("general", True),
    ("general", False)])
def test_trace_chunk_matches_jax(lens_model, diffraction):
    cfg, (js, ts), src, r1, r2 = _point_scene(lens_model, diffraction)
    args = _chunk_arrays(src, r1, r2)
    ref = jrender.trace_chunk(
        tuple(jnp.asarray(a) for a in args),
        jrender.RenderParams.from_setup(cfg, js, src), js.elements, None,
        js.rotation_matrix, js.inverse_rotation_matrix, {})
    got = render.trace_chunk(
        tuple(torch.tensor(a) for a in args),
        render.RenderParams.from_setup(port_config(cfg), ts,
                                       port_source(src)),
        ts.elements, None, ts.rotation_matrix, ts.inverse_rotation_matrix, {})
    hold_image(got.numpy(), ref)


@pytest.fixture(scope="module")
def general():
    """tests/test_fast.py's scene (general lens, 6 dots, 32 rays) and its
    gradient volume, on both sides."""
    cfg, setup, src, _, _, r1, r2 = fast_scene("general")
    vol, _, _ = gradient_volume_between(setup)
    tcfg = port_config(cfg)
    return dict(jax=(cfg, setup, src, r1, r2), jvol=vol,
                torch=(tcfg, camera_setup(tcfg), port_source(src),
                       np.asarray(r1), np.asarray(r2)),
                tvol=port_volume(vol))


@pytest.mark.parametrize("algorithm", [0, 1, 2])
def test_render_image_matches_jax(general, algorithm):
    """No volume (0), and Euler (1) or RK4 (2) through the gradient volume;
    the particles in three chunks."""
    jmarch = tmarch = None
    if algorithm:
        jmarch = jax_make_march_fn(general["jvol"], algorithm=algorithm)
        tmarch = make_march_fn(general["tvol"], algorithm=algorithm)
    ref = jrender.render_image(*general["jax"], march_fn=jmarch,
                               rays_per_chunk=20 * 32)
    got = render.render_image(*general["torch"], march_fn=tmarch,
                              rays_per_chunk=20 * 32, device="cpu")
    hold_image(got.numpy(), ref)


def test_render_image_bilinear_and_thin_lens_rotated_march(general):
    """The bilinear sensor, and the thin lens with a rotated camera
    marching the volume."""
    for edit in ({"camera_design.implement_diffraction": False},
                 {"lens_design.lens_model": "thin-lens",
                  "camera_design.x_camera_angle": 0.05,
                  "camera_design.y_camera_angle": -0.03}):
        cfg = copy.deepcopy(general["jax"][0])
        for k, v in edit.items():
            section, key = k.split(".")
            setattr(getattr(cfg, section), key, v)
        tcfg = port_config(cfg)
        marched = "lens_design.lens_model" in edit
        ref = jrender.render_image(
            cfg, jax_camera_setup(cfg), *general["jax"][2:],
            march_fn=jax_make_march_fn(general["jvol"]) if marched else None)
        got = render.render_image(
            tcfg, camera_setup(tcfg), *general["torch"][2:],
            march_fn=make_march_fn(general["tvol"]) if marched else None,
            device="cpu")
        hold_image(got.numpy(), ref)


@pytest.mark.parametrize("lens_model", ["apparent", "general"])
def test_position_noise_with_injected_normals(lens_model):
    """Sensor position noise of 0.5 px: the JAX package's normals for the
    chunk's key, drawn as its ``_apply_position_noise`` draws them, go into
    the port's trace_chunk."""
    cfg, (js, ts), src, r1, r2 = _point_scene(lens_model)
    cfg.density_gradients.add_pos_noise = True
    cfg.density_gradients.pos_noise_std = 0.5
    tcfg = port_config(cfg)
    tsrc = port_source(src)
    args = _chunk_arrays(src, r1, r2)
    key = jax.random.key(4)
    ref = jrender.trace_chunk(
        tuple(jnp.asarray(a) for a in args),
        jrender.RenderParams.from_setup(cfg, js, src), js.elements, None,
        js.rotation_matrix, js.inverse_rotation_matrix, {}, noise_key=key)
    n = len(src.x) * len(r1)
    normals = np.asarray(jax.random.normal(key, (n, 2), dtype=jnp.float32))
    tparams = render.RenderParams.from_setup(tcfg, ts, tsrc)
    got = render.trace_chunk(
        tuple(torch.tensor(a) for a in args), tparams, ts.elements, None,
        ts.rotation_matrix, ts.inverse_rotation_matrix, {},
        normals=torch.tensor(normals))
    hold_image(got.numpy(), ref)
    plain = render.trace_chunk(
        tuple(torch.tensor(a) for a in args),
        tparams.__class__(**{**tparams.__dict__, "add_pos_noise": False}),
        ts.elements, None, ts.rotation_matrix, ts.inverse_rotation_matrix,
        {})
    assert rel_l1(got.numpy(), plain.numpy()) > 0.05    # the noise shows
    # render_image draws the chunks' normals itself, from its seed
    a = render.render_image(tcfg, ts, tsrc, r1, r2, noise_seed=3,
                            device="cpu")
    b = render.render_image(tcfg, ts, tsrc, r1, r2, noise_seed=3,
                            rays_per_chunk=2 * len(r1), device="cpu")
    assert torch.equal(a, render.render_image(tcfg, ts, tsrc, r1, r2,
                                              noise_seed=3, device="cpu"))
    assert b.sum() > 0


def test_render_rays_matches_jax(general):
    """The final per-ray state (the reference's dump layout) with the
    volume: sensor-plane positions within 1e-2 px (0.17 um; the lens's
    sqrt ulp moves them by up to 0.05 um), directions within 1e-5."""
    cfg, setup, src, r1, r2 = general["jax"]
    ref = jrender.render_rays(cfg, setup, src, r1, r2,
                              march_fn=jax_make_march_fn(general["jvol"]))
    got = render.render_rays(*general["torch"],
                             march_fn=make_march_fn(general["tvol"]),
                             device="cpu")
    for g, r, tol in ((got.pos, ref.pos, 0.01 * cfg.camera_design.pixel_pitch),
                      (got.dir, ref.dir, 1e-5)):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r))
        fin = np.isfinite(r)
        assert fin.mean() > 0.5
        assert np.abs(g[fin] - r[fin]).max() <= tol


# ---------------------------------------------------------------------------
# tests/test_fast.py's pairs through the port's two renderers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens_model", ["apparent", "thin-lens", "general"])
def test_fast_matches_exact_no_gradients(lens_model):
    cfg, setup, src, _, _, r1, r2 = fast_scene(lens_model)
    tcfg = port_config(cfg)
    args = (tcfg, camera_setup(tcfg), port_source(src), np.asarray(r1),
            np.asarray(r2))
    exact = render.render_image(*args, device="cpu").numpy()
    fast = render_image_fast(*args, device="cpu").numpy()
    assert exact.sum() > 0
    l1 = rel_l1(fast, exact)
    print(f"{lens_model}: fast against exact L1 {l1:.3g}")
    assert l1 < 1e-3, l1            # test_fast.py's budget
    assert np.unravel_index(exact.argmax(), exact.shape) \
        == np.unravel_index(fast.argmax(), fast.shape)


def test_fast_matches_exact_with_gradients(general):
    exact = render.render_image(*general["torch"],
                                march_fn=make_march_fn(general["tvol"]),
                                device="cpu").numpy()
    fast = render_image_fast(*general["torch"], vol=general["tvol"],
                             device="cpu").numpy()
    l1 = rel_l1(fast, exact)
    print(f"with the volume: fast against exact L1 {l1:.3g}")
    assert l1 < 0.01, l1            # test_fast.py's budget


# ---------------------------------------------------------------------------
# the reference sample scene's camera through run_bos and run_piv
# ---------------------------------------------------------------------------

def volume_across_rays(setup, half, fracs=(0.1, 0.6), shape=(12, 10, 14)):
    """A density ramp along x in a box that holds, in the march's (world)
    frame, the rays from a +-``half`` square of the object plane toward the
    lens between the fractions ``fracs`` of their way; returns (rho,
    spacings, origin) in the NRRD frame (world z + 750e3)."""
    shift = setup.z_offset + 750e3
    inv = np.asarray(setup.inverse_rotation_matrix, np.float64)
    corners = np.array([[sx * half, sy * half, setup.z_object]
                        for sx in (-1, 1) for sy in (-1, 1)])
    lens = np.array([0.0, 0.0, setup.z_lens])
    pts = np.concatenate([corners + f * (lens - corners)
                          for f in np.linspace(*fracs, 5)])
    world = (pts - [0.0, 0.0, shift]) @ inv.T
    lo, hi = world.min(0), world.max(0)
    pad = 0.1 * (hi - lo).max()
    lo, hi = lo - pad, hi + pad
    axes = [np.linspace(lo[a], hi[a], shape[a]) for a in range(3)]
    x = axes[0]
    rho = 1.225 + 4.0 * (x[:, None, None] - x.min()) / (x.max() - x.min()) \
        * np.ones((1, shape[1], shape[2]))
    spacings = [ax[1] - ax[0] for ax in axes]
    origin = [axes[0][0], axes[1][0], axes[2][0] + 750e3]
    return rho, spacings, origin


def _rotated_case(d, cfg, half):
    """``cfg`` with the sample scene's camera and a volume across its rays
    (NRRD under ``d``)."""
    cfg.camera_design.y_camera_angle = SAMPLE_ANGLE
    cfg.reference_lens_rng = True
    rho, spacings, origin = volume_across_rays(jax_camera_setup(cfg), half)
    nrrd = str(d / "rho.nrrd")
    write_nrrd(nrrd, rho.astype(np.float32), spacings=spacings,
               space_origin=origin)
    cfg.density_gradients.simulate_density_gradients = True
    cfg.density_gradients.density_gradient_filename = nrrd
    return cfg


@pytest.fixture
def exact_route(monkeypatch):
    """Every image must go through the exact renderer: the fast one raises,
    and the exact renders are counted."""
    calls = []
    exact = pipeline.render_image

    def counted(*a, **kw):
        calls.append(kw.get("march_fn") is not None)
        return exact(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the fast renderer was called")

    monkeypatch.setattr(pipeline, "render_image", counted)
    monkeypatch.setattr(pipeline, "render_image_fast", refuse)
    return calls


def test_run_bos_sample_camera_matches_jax(tmp_path, exact_route):
    """The sample scene's camera (thin lens, Euler; tests/test_sample_scene
    .py:1-21) on a small BOS case: both images through the exact path, as
    in the JAX package, each within the budget of the JAX package's."""
    cfg = bos_case("thin-lens", n_dots=4, rays=16)
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
    cfg.density_gradients.ray_tracing_algorithm = 1
    cfg = _rotated_case(tmp_path, cfg, cfg.bos_pattern.X_Max)
    tcfg = port_config(cfg)
    assert not pipeline.can_use_fast_renderer(
        tcfg, camera_setup(tcfg),
        vol=pipeline._load_volume(tcfg, torch.device("cpu")))
    # without the volume the fast renderer covers the camera
    assert pipeline.can_use_fast_renderer(tcfg, camera_setup(tcfg))
    ref = jax_run_bos(cfg, rng=np.random.default_rng(11))
    got = pipeline.run_bos(port_config(cfg), rng=np.random.default_rng(11),
                           device="cpu")
    assert exact_route == [False, True]
    for name in ref.raw_images:
        print(name)
        hold_image(got.raw_images[name], ref.raw_images[name])
    im1, im2 = (got.raw_images[n] for n in sorted(got.raw_images))
    moved = rel_l1(im2, im1)
    print(f"im2 against im1: L1 {moved:.3g}")
    assert moved > 1e-2


def test_run_piv_sample_camera_matches_jax(tmp_path, exact_route):
    """A small PIV case with Mie scattering (the general lens, RK4) and the
    sample scene's camera: both frames through the exact path.

    Here the JAX package's jitted run and its op-by-op run
    (``jax.disable_jit``) differ by about 1e-3 (L1; printed): the rays
    cross the volume diagonally, a fused step rounds differently, and a ray
    can commit one RK4 step more or less at the exit face, which the lens
    of index 477 turns into a visible move.  The port runs
    the formulas op by op: it is held to the op-by-op run at the budget,
    and to the jitted run no farther than the op-by-op run is, plus the
    budget."""
    from photon_tpu.config import default_config as jax_default_config
    cfg = jax_default_config("piv")
    cfg.camera_design.x_pixel_number = 96
    cfg.camera_design.y_pixel_number = 64
    pf = cfg.particle_field
    pf.particle_number = 60
    pf.lightray_number_per_particle = 16
    pf.lightray_process_number = 25 * 16
    pf.mie_scattering_angle_number = 32
    pf.particle_diameter_number = 9
    m = cfg.lens_design.focal_length / (cfg.lens_design.object_distance
                                        - cfg.lens_design.focal_length)
    half = 0.7 * 64 * cfg.camera_design.pixel_pitch / 2.0 / m
    pf.X_Min, pf.X_Max, pf.Y_Min, pf.Y_Max = -half, half, -half, half
    cfg = _rotated_case(tmp_path, cfg, half)
    jitted = jax_run_piv(cfg, rng=np.random.default_rng(11))
    with jax.disable_jit():
        ref = jax_run_piv(cfg, rng=np.random.default_rng(11))
    got = pipeline.run_piv(port_config(cfg), rng=np.random.default_rng(11),
                           device="cpu")
    assert exact_route == [True, True]
    assert list(got.raw_images) == list(ref.raw_images)
    for name in ref.raw_images:
        print(name)
        hold_image(got.raw_images[name], ref.raw_images[name])
        spread = rel_l1(ref.raw_images[name], jitted.raw_images[name])
        d = rel_l1(got.raw_images[name], jitted.raw_images[name])
        print(f"    against the jitted run: L1 {d:.3g} (op by op: "
              f"{spread:.3g})")
        assert d <= spread + _L1, (d, spread)


# ---------------------------------------------------------------------------
# chip_smoke's bench ramp: how far the JAX package's own two renderers differ
# ---------------------------------------------------------------------------

def test_fast_against_exact_on_the_bench_ramp(monkeypatch):
    """chip_smoke.py's bench scene (the 64^3 ramp of 5.0 in rho across
    3e5 um, which ends 100 um below the dots) at 128^2 with 12 dots and 16
    rays.  Here the JAX package's fast and exact renderers differ by more
    than tests/test_fast.py's 1e-2 (3.5e-2: the exact RK4 freezes a ray
    mid-step at the exit face, one step of a strong deflection short); the
    port's two renderers differ as the JAX package's do, within 1e-3, and
    its exact im2 is within the budget of the JAX package's."""
    import json
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    monkeypatch.setattr(chip_smoke, "BENCH_SENSOR", 128)
    monkeypatch.setattr(chip_smoke, "BENCH_DOTS", 12)
    monkeypatch.setattr(chip_smoke, "BENCH_RAYS", 16)
    import photon_tpu.config as jconfig
    from photon_tpu.models.render_fast import \
        render_image_fast as jax_render_fast
    from photon_tpu.models.scenes import bos_source as jax_bos_source
    from photon_tpu.volume import build_density_volume
    from photon_tpu_torch.volume import \
        build_density_volume as port_build_volume
    tcfg, tsetup, rho, spacings, origin = chip_smoke.bench_scene()
    cfg = jconfig.SimulationConfig.from_dict(json.loads(tcfg.to_json()))
    setup = jax_camera_setup(cfg)
    src, _, _ = jax_bos_source(cfg, setup, np.random.default_rng(cfg.seed))
    r1, r2 = (np.asarray(a) for a in jax_lens_samples(jax.random.key(2),
                                                      16))
    jvol = build_density_volume(rho, spacings, origin)
    tvol = port_build_volume(rho, spacings, origin, device="cpu")
    j_exact = np.asarray(jrender.render_image(
        cfg, setup, src, r1, r2, march_fn=jax_make_march_fn(jvol)))
    j_fast = np.asarray(jax_render_fast(cfg, setup, src, r1, r2, vol=jvol))
    args = (tcfg, tsetup, port_source(src), r1, r2)
    t_exact = render.render_image(*args, march_fn=make_march_fn(tvol),
                                  device="cpu").numpy()
    t_fast = render_image_fast(*args, vol=tvol, device="cpu").numpy()
    gap_jax = rel_l1(j_fast, j_exact)
    gap_port = rel_l1(t_fast, t_exact)
    print(f"fast against exact: JAX {gap_jax:.4g}, port {gap_port:.4g}")
    assert gap_jax > 1e-2
    assert abs(gap_port - gap_jax) <= 1e-3
    hold_image(t_exact, j_exact)
