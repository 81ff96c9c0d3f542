"""Port vs JAX: the per-ray (P, R) chain of the fast renderer.

A rotated camera (with and without a density volume), the bilinear sensor,
per-ray erf spots, sensor position noise and ``chief_march=False``, each
through both packages' ``render_image_fast`` on the goldens' scenes (128^2
sensor, 5 dots, 24 rays; 12^3 volume); the per-ray deposits on their own;
the gradient of a rotated render; ``run_bos`` end to end; and the Mie
factor of a rotated PIV camera.
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.render_fast import render_image_fast as jax_render
from photon_tpu.ops import sensor_fast as jax_sensor
from photon_tpu.pipeline import run_bos as jax_run_bos
from photon_tpu_torch.models import render_fast
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.ops import sensor_fast
from photon_tpu_torch.pipeline import run_bos
from photon_tpu_torch.utils.nrrd_io import write_nrrd
from tests.test_bos_pipeline import bos_case, gradient_volume_between
from tests.test_golden import GOLDEN_DIR, _bos_scene
from tests.torch_port_helpers import (port_config, port_source, port_volume,
                                      rel_l1)

# the JAX package's fast-vs-exact budget (tests/test_fast.py), the port's
# _L1 (tests/test_torch_render.py)
_L1 = 1e-3
# the bound the port's tests hold two marches to (tests/test_torch_render.py)
_L1_MARCH = 2e-3
ANGLES = {"camera_design.x_camera_angle": 0.05,
          "camera_design.y_camera_angle": -0.03}   # tests/test_fan_pallas.py


def _both(with_volume=True, **over):
    """The goldens' BOS scene (tests/test_golden.py::_bos_scene, 128^2) with
    config edits ``over``, on both sides: (JAX args, port args, JAX volume,
    port volume)."""
    cfg, setup, src, r1, r2 = _bos_scene(sensor=128, **over)
    r1, r2 = np.asarray(r1), np.asarray(r2)
    tcfg = port_config(cfg)
    jv = tv = None
    if with_volume:
        jv, *_ = gradient_volume_between(setup, n=12)
        tv = port_volume(jv)
    return ((cfg, setup, src, r1, r2),
            (tcfg, camera_setup(tcfg), port_source(src), r1, r2), jv, tv)


def _render_pair(over, with_volume, **kw):
    j, t, jv, tv = _both(with_volume, **over)
    ref = np.asarray(jax_render(*j, vol=jv, **kw))
    got = render_image_fast(*t, vol=tv, device="cpu", **kw).numpy()
    return got, ref


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,over,with_volume", [
    ("bos_rotated_128", {"camera_design.x_camera_angle": 0.05}, True),
    ("bos_bilinear_128", {"camera_design.implement_diffraction": False},
     False)])
def test_golden_through_the_port(name, over, with_volume):
    """tests/test_golden.py's cases through the port on the CPU, within that
    test's tolerance (rtol 2e-3, atol 1e-6 of the maximum).

    The goldens hold the JAX package's jitted render, whose fused arithmetic
    moves a few edge pixels of the per-ray chain by 2e-3..3.4e-3 of their
    value: the same package run op by op (``jax.disable_jit``) misses them
    on the same pixels as the port (4 and 6), and the port equals it there
    to 2e-7.  So the port is held to the golden on every pixel where the op
    by op reference holds it, and to the op by op reference, with the same
    tolerance, on every pixel."""
    j, t, jv, tv = _both(with_volume, **over)
    got = render_image_fast(*t, vol=tv, device="cpu").numpy()
    golden = np.load(os.path.join(GOLDEN_DIR, name + ".npy"))
    atol = 1e-6 * max(golden.max(), 1.0)
    with jax.disable_jit():
        eager = np.asarray(jax_render(*j, vol=jv))
    missed = np.abs(eager - golden) > 2e-3 * np.abs(golden) + atol
    print(f"{name}: L1 {rel_l1(got, golden):.3g} of the golden's sum; the "
          f"op by op reference misses {int(missed.sum())} pixels")
    assert got.sum() > 0 and missed.sum() <= 8
    np.testing.assert_allclose(got[~missed], golden[~missed], rtol=2e-3,
                               atol=atol)
    np.testing.assert_allclose(got, eager, rtol=2e-3, atol=atol)


@pytest.mark.parametrize("name,sensor,over,kw", [
    ("golden_bos_64", 64, {}, {}),
    ("bos_tricubic_rk45_128", 128,
     {"density_gradients.interpolation_scheme": 2,
      "density_gradients.ray_tracing_algorithm": 3},
     dict(algorithm=3, interpolation_scheme=2))])
def test_fast_goldens_through_the_port(name, sensor, over, kw):
    """tests/test_golden.py's RK4 trilinear 64^2 golden and its tricubic
    RK45-substep 128^2 golden (both through render_image_fast with the 12^3
    gradient volume) through the port on the CPU, at that test's tolerance:
    rtol 2e-3, atol 1e-6 of the golden's maximum, on every pixel."""
    from tests.test_golden import LEGACY_GOLDEN
    cfg, setup, src, r1, r2 = _bos_scene(sensor=sensor, **over)
    vol, *_ = gradient_volume_between(setup, n=12)
    tcfg = port_config(cfg)
    got = render_image_fast(tcfg, camera_setup(tcfg), port_source(src),
                            np.asarray(r1), np.asarray(r2),
                            vol=port_volume(vol), device="cpu", **kw).numpy()
    path = LEGACY_GOLDEN if name == "golden_bos_64" \
        else os.path.join(GOLDEN_DIR, name + ".npy")
    golden = np.load(path)
    print(f"{name}: L1 {rel_l1(got, golden):.3g} of the golden's sum")
    assert got.sum() > 0 and got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=2e-3,
                               atol=1e-6 * max(golden.max(), 1.0))


# ---------------------------------------------------------------------------
# render_image_fast against the JAX package's
# ---------------------------------------------------------------------------

CASES = {
    "rotated camera, no volume": (ANGLES, False, {}),
    "rotated camera, volume": (ANGLES, True, {}),
    "rotated camera, volume, apparent lens": (
        {**ANGLES, "lens_design.lens_model": "apparent"}, True, {}),
    "rotated camera, volume, thin lens": (
        {**ANGLES, "lens_design.lens_model": "thin-lens"}, True, {}),
    "bilinear sensor": ({"camera_design.implement_diffraction": False},
                        False, {}),
    "bilinear sensor, volume": (
        {"camera_design.implement_diffraction": False}, True, {}),
    "bilinear sensor, rotated camera, volume": (
        {**ANGLES, "camera_design.implement_diffraction": False}, True, {}),
    "per_ray_splat": ({}, False, dict(per_ray_splat=True)),
    "per_ray_splat, volume": ({}, True, dict(per_ray_splat=True)),
    "per_ray_splat, rotated camera, volume": (
        ANGLES, True, dict(per_ray_splat=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax(case):
    over, with_volume, kw = CASES[case]
    got, ref = _render_pair(over, with_volume, **kw)
    assert ref.sum() > 0 and got.dtype == np.float32
    assert np.isfinite(got).all()
    l1 = rel_l1(got, ref)
    print(f"{case}: L1 {l1:.3g}")
    assert l1 < _L1, l1


def test_the_volume_moves_the_rotated_render():
    """The rotated march is not a no-op: im2 differs from im1."""
    j, t, _, tv = _both(True, **ANGLES)
    im1 = render_image_fast(*t, device="cpu").numpy()
    im2 = render_image_fast(*t, vol=tv, device="cpu").numpy()
    assert rel_l1(im2, im1) > 0.05


@pytest.mark.parametrize("rotated", [False, True])
def test_chief_march_false_matches_the_jax_tube_march(rotated):
    """Every fan ray marched on its own (the port through the gather march,
    the JAX package through its voxel-tube march)."""
    got, ref = _render_pair(ANGLES if rotated else {}, True,
                            chief_march=False)
    l1 = rel_l1(got, ref)
    print(f"chief_march=False, rotated={rotated}: L1 {l1:.3g}")
    assert np.isfinite(got).all() and got.sum() > 0
    assert l1 < _L1_MARCH, l1


def test_chief_march_false_marches_every_ray(monkeypatch):
    """The per-ray march takes P x R rays a chunk; the chief march P."""
    seen = []
    real = render_fast.chief_deltas_dense

    def counting(vol, *rays, **kw):
        seen.append(rays[0].shape[0])
        return real(vol, *rays, **kw)

    monkeypatch.setattr(render_fast, "chief_deltas_dense", counting)
    _, t, _, tv = _both(True)
    P, R = t[2].num_particles, len(t[3])
    render_image_fast(*t, vol=tv, device="cpu")
    render_image_fast(*t, vol=tv, chief_march=False, device="cpu",
                      particles_per_chunk=P // 2 + 1)
    assert seen == [P, (P // 2 + 1) * R, (P - P // 2 - 1) * R]


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over,with_volume,kw,fan_kernel_route", [
    (ANGLES, False, {}, True),
    (ANGLES, True, {}, False),
    ({}, True, {}, True),
    ({"camera_design.implement_diffraction": False}, False, {}, False),
    ({}, False, dict(per_ray_splat=True), False),
    ({}, True, dict(chief_march=False), False),
    ({}, False, dict(chief_march=False), True)])
def test_route(monkeypatch, over, with_volume, kw, fan_kernel_route):
    """The fan kernel's wrapper serves the configurations it covers (a
    rotated camera without a volume among them: the rotation enters only a
    marched fan); the per-ray chain the rest."""
    calls = {"fan_stats": 0, "_ray_chain": 0}
    for name in calls:
        real = getattr(render_fast, name)

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(render_fast, name, counting)
    _, t, _, tv = _both(with_volume, **over)
    render_image_fast(*t, vol=tv, device="cpu", **kw)
    assert calls == ({"fan_stats": 1, "_ray_chain": 0} if fan_kernel_route
                     else {"fan_stats": 0, "_ray_chain": 1})


# ---------------------------------------------------------------------------
# sensor position noise
# ---------------------------------------------------------------------------

NOISE = {"density_gradients.add_pos_noise": True,
         "density_gradients.pos_noise_std": 0.5}


@pytest.mark.parametrize("with_volume", [False, True])
def test_noise_with_the_jax_draws_matches_jax(monkeypatch, with_volume):
    """JAX's own normals (jax.random.normal of the noise seed's key, one
    chunk) injected into the port's chunk: the same image."""
    j, t, jv, tv = _both(with_volume, **NOISE)
    P, R = t[2].num_particles, len(t[3])
    seed = 1234
    draws = np.asarray(jax.random.normal(jax.random.key(seed), (2, P, R),
                                         dtype=jnp.float32))
    ref = np.asarray(jax_render(*j, vol=jv, noise_seed=seed))
    monkeypatch.setattr(render_fast, "_chunk_normals",
                        lambda gen, n, r: torch.from_numpy(np.array(draws)))
    got = render_image_fast(*t, vol=tv, noise_seed=seed,
                            device="cpu").numpy()
    l1 = rel_l1(got, ref)
    print(f"noise with JAX's draws, volume={with_volume}: L1 {l1:.3g}")
    # the noise moves the spots: the comparison is not of two clean images
    clean = np.asarray(jax_render(*_both(with_volume)[0], vol=jv))
    assert rel_l1(ref, clean) > 0.05
    assert l1 < _L1, l1


def test_noise_spreads_spots_by_its_variance():
    """tests/test_march_dense.py::test_position_noise_spreads_spots through
    the port: a spot's second moment grows by std^2 (in pixels) within
    25%, its sum is conserved to 5%, and two renders with one seed are
    equal."""
    noise_px = 2.0
    cfg = bos_case("apparent", n_dots=6, rays=256)
    cfg.bos_pattern.grid_point_number = 1
    tcfg = port_config(cfg)
    setup = camera_setup(tcfg)
    from photon_tpu.models.scenes import bos_source as jax_bos_source
    from photon_tpu.utils.rng import lens_samples as jax_lens_samples
    src = port_source(jax_bos_source(cfg, jax_camera_setup(cfg),
                                     np.random.default_rng(11))[0])
    r1, r2 = (np.asarray(a) for a in jax_lens_samples(jax.random.key(5),
                                                      256))

    def second_moment(im):
        ys, xs = np.mgrid[0:im.shape[0], 0:im.shape[1]]
        w = im / im.sum()
        cx, cy = (w * xs).sum(), (w * ys).sum()
        return ((w * ((xs - cx) ** 2 + (ys - cy) ** 2)).sum()) / 2.0

    base = render_image_fast(tcfg, setup, src, r1, r2, device="cpu").numpy()
    tcfg.density_gradients.add_pos_noise = True
    tcfg.density_gradients.pos_noise_std = noise_px
    noisy = render_image_fast(tcfg, setup, src, r1, r2, device="cpu")
    again = render_image_fast(tcfg, setup, src, r1, r2, device="cpu")
    other = render_image_fast(tcfg, setup, src, r1, r2, noise_seed=7,
                              device="cpu")
    noisy_np = noisy.numpy()
    dvar = second_moment(noisy_np) - second_moment(base)
    print(f"second moment grew by {dvar:.4g} px^2 (std^2 = {noise_px ** 2})")
    assert dvar == pytest.approx(noise_px ** 2, rel=0.25), dvar
    np.testing.assert_allclose(noisy_np.sum(), base.sum(), rtol=0.05)
    assert torch.equal(noisy, again)
    assert not torch.equal(noisy, other)


def test_noise_draws_chunk_by_chunk(monkeypatch):
    """Each chunk draws its own (2, n, R) normals from the one generator, in
    chunk order; a chunked render repeats with its seed."""
    shapes = []
    real = render_fast._chunk_normals

    def keep(gen, n, r):
        shapes.append((n, r))
        return real(gen, n, r)

    monkeypatch.setattr(render_fast, "_chunk_normals", keep)
    _, t, _, _ = _both(False, **NOISE)
    P, R = t[2].num_particles, len(t[3])
    a = render_image_fast(*t, device="cpu", particles_per_chunk=P - 3)
    b = render_image_fast(*t, device="cpu", particles_per_chunk=P - 3)
    assert shapes == [(P - 3, R), (3, R)] * 2
    assert torch.equal(a, b) and float(a.sum()) > 0


# ---------------------------------------------------------------------------
# the per-ray deposits on their own
# ---------------------------------------------------------------------------

def _deposit_inputs(seed=3, P=9, R=17, n=40):
    """Rays scattered around anchors, a few culled (zero amplitude), one
    not finite, one anchor beyond the frame's edge."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-2, n + 2, (P, 2))
    X = (centre[:, :1] + rng.normal(0, 1.5, (P, R))).astype(np.float32)
    Y = (centre[:, 1:] + rng.normal(0, 1.5, (P, R))).astype(np.float32)
    amp = rng.uniform(0.1, 2.0, (P, R)).astype(np.float32)
    amp[0, :3] = 0.0
    X[1, 2] = np.inf
    pred_col = np.round(centre[:, 0]).astype(np.int32)
    pred_row = np.round(centre[:, 1]).astype(np.int32)
    pred_col[-1] = -10**6
    return X, Y, amp, pred_col, pred_row


@pytest.mark.parametrize("patch", [6, 12])
def test_patch_splat_matches_jax(patch):
    args = _deposit_inputs()
    ref = np.asarray(jax_sensor.patch_splat(*args, nx=40, ny=33,
                                            diameter=3.0, patch=patch))
    got = sensor_fast.patch_splat(*map(torch.from_numpy, args), nx=40, ny=33,
                                  diameter=3.0, patch=patch).numpy()
    assert ref.sum() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * ref.max())


@pytest.mark.parametrize("patch", [6, 12])
def test_bilinear_patch_splat_matches_jax(patch):
    args = _deposit_inputs(seed=4)
    ref = np.asarray(jax_sensor.bilinear_patch_splat(*args, nx=40, ny=33,
                                                     patch=patch))
    got = sensor_fast.bilinear_patch_splat(*map(torch.from_numpy, args),
                                           nx=40, ny=33, patch=patch).numpy()
    assert ref.sum() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * ref.max())


def test_patch_product_gradient_and_precision():
    """The deposits' product over rays: autograd against gradcheck in
    float64, and full float32 with TF32 asked for globally (the flag is
    restored)."""
    g = torch.Generator().manual_seed(0)
    wy = torch.rand((4, 3, 5), generator=g, dtype=torch.float64,
                    requires_grad=True)
    wx = torch.rand((4, 3, 5), generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(sensor_fast._PatchProduct.apply,
                                    (wy, wx))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = sensor_fast._PatchProduct.apply(wy.float(), wx.float())
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    ref = torch.einsum("ipr,jpr->pij", wy, wx)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def test_to_camera_undoes_to_world():
    _, t, _, _ = _both(False, **ANGLES)
    setup = t[1]
    rot = render_fast._f32_rows(setup.rotation_matrix)
    inv = render_fast._f32_rows(setup.inverse_rotation_matrix)
    g = torch.Generator().manual_seed(1)
    pos = torch.rand((3, 4, 6), generator=g) * 1e5
    d = torch.nn.functional.normalize(torch.rand((3, 4, 6), generator=g) - 1,
                                      dim=0)
    back = render_fast._to_camera(
        rot, 850e3, *render_fast._to_world(inv, 850e3, *pos, *d))
    # positions to a few roundings of the shifted z (~8.5e5 um), directions
    # to a few of a unit vector
    for a, b, atol in zip(back, (*pos, *d), (0.5,) * 3 + (1e-6,) * 3):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_rotated_field_gradient_matches_jax():
    """d mean(img^2) / d field for a rotated camera: cosine >= 0.9999
    (tests/test_fan_pallas.py:67-78's bar)."""
    j, t, jv, tv = _both(True, **ANGLES)
    ref = np.asarray(jax.grad(lambda f: jnp.mean(jax_render(
        *j, vol=jv._replace(field=f)) ** 2))(jv.field))
    field = tv.field.clone().requires_grad_(True)
    img = render_image_fast(*t, vol=tv._replace(field=field), device="cpu")
    torch.mean(img ** 2).backward()
    got = field.grad.numpy()
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    cos = _cosine(got, ref)
    print(f"rotated field gradient: cosine {cos:.7f}")
    assert cos >= 0.9999, cos


# ---------------------------------------------------------------------------
# run_bos end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bos_nrrd(tmp_path_factory):
    """A small BOS case whose volume both packages read from one NRRD."""
    d = tmp_path_factory.mktemp("chain_bos")
    cfg = bos_case("general", n_dots=4, rays=16)
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
    cfg.reference_lens_rng = True       # both sides draw GlibcRand samples
    setup = jax_camera_setup(cfg)
    w, h, dd = 12, 10, 14
    x = np.linspace(-2e5, 2e5, w)
    y = np.linspace(-2e5, 2e5, h)
    z = np.linspace(setup.object_distance * 0.4,
                    setup.object_distance * 0.9, dd)
    rho = 1.225 + 4.0 * (x[:, None, None] - x.min()) / (x.max() - x.min()) \
        * np.ones((1, h, dd))
    nrrd = str(d / "rho.nrrd")
    write_nrrd(nrrd, rho.astype(np.float32),
               spacings=(x[1] - x[0], y[1] - y[0], z[1] - z[0]),
               space_origin=(x[0], y[0], z[0]))
    cfg.density_gradients.simulate_density_gradients = True
    cfg.density_gradients.density_gradient_filename = nrrd
    return cfg


RUN_BOS = {
    "rotated camera": ANGLES,
    "bilinear sensor": {"camera_design.implement_diffraction": False},
    "rotated camera, bilinear sensor": {
        **ANGLES, "camera_design.implement_diffraction": False},
}


@pytest.mark.parametrize("case", sorted(RUN_BOS))
def test_run_bos_matches_jax(bos_nrrd, case):
    cfg = copy.deepcopy(bos_nrrd)
    for k, v in RUN_BOS[case].items():
        section, key = k.split(".")
        setattr(getattr(cfg, section), key, v)
    ref = jax_run_bos(cfg, rng=np.random.default_rng(11))
    got = run_bos(port_config(cfg), rng=np.random.default_rng(11),
                  device="cpu")
    for name in ref.raw_images:
        l1 = rel_l1(got.raw_images[name], ref.raw_images[name])
        print(f"{case}, {name}: raw L1 {l1:.3g}")
        assert l1 < _L1, (name, l1)
    im1, im2 = (got.raw_images[n] for n in sorted(got.raw_images))
    assert np.abs(im1 - im2).sum() > 1e-3 * im1.sum()


def test_run_bos_seeds_each_image_as_the_jax_package(bos_nrrd, monkeypatch):
    """im1 takes cfg.seed + 0, im2 cfg.seed + 1 as its noise seed
    (photon_tpu/pipeline.py:201, 208)."""
    from photon_tpu_torch import pipeline
    seeds = []
    real = pipeline.render_image_fast

    def keep(*a, noise_seed=None, **kw):
        seeds.append(noise_seed)
        return real(*a, noise_seed=noise_seed, **kw)

    monkeypatch.setattr(pipeline, "render_image_fast", keep)
    cfg = port_config(bos_nrrd)
    cfg.density_gradients.add_pos_noise = True
    cfg.density_gradients.pos_noise_std = 0.5
    got = run_bos(cfg, rng=np.random.default_rng(11), device="cpu")
    assert seeds == [cfg.seed, cfg.seed + 1]
    assert all(np.isfinite(v).all() and v.sum() > 0
               for v in got.raw_images.values())


# ---------------------------------------------------------------------------
# the Mie factor of a rotated camera
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mie_scene():
    """A PIV scene of a few hundred particles with a tilted beam, its Mie
    table (the port's), and the camera rotated by ANGLES."""
    from photon_tpu_torch.models import scenes
    from photon_tpu_torch.models.render import RenderParams
    from photon_tpu_torch.ops import mie
    from tests.test_torch_piv import golden_piv_config
    cfg = golden_piv_config()
    cfg.particle_field.particle_number = 400
    cfg.particle_field.beam_propogation_vector = (0.3, 1.0, -0.2)
    cfg.camera_design.x_camera_angle = ANGLES["camera_design.x_camera_angle"]
    cfg.camera_design.y_camera_angle = ANGLES["camera_design.y_camera_angle"]
    tcfg = port_config(cfg)
    rng = np.random.default_rng(2)
    scat = mie.create_mie_scattering_data(tcfg, rng)
    setup = camera_setup(tcfg)
    src = scenes.piv_source(tcfg, setup, 1, diameter_index_distribution=scat[
        "particle_diameter_index_distribution"], rng=rng)
    params = RenderParams.from_setup(tcfg, setup, src)
    return params.image_distance, src, scat, setup


def _lookup(scat, src, cosang):
    """The table's linear interpolation in angle (ref: :186-201)."""
    angles = np.asarray(scat["scattering_angle"])
    table = np.asarray(scat["scattering_irradiance"], np.float32)
    a = (np.arccos(np.clip(cosang, -1.0, 1.0)) - angles[0]) \
        / (angles[1] - angles[0])
    a0 = np.clip(np.floor(a).astype(np.int32), 0, table.shape[0] - 2)
    frac = (a - a0).astype(np.float32)
    d = src.diameter_index
    return table[a0, d] + frac * (table[a0 + 1, d] - table[a0, d])


def _chief_dirs(image_distance, src):
    dden = image_distance - src.z.astype(np.float64)
    ctx, cty = src.x / dden, src.y / dden
    cinv = 1.0 / np.sqrt(ctx * ctx + cty * cty + 1.0)
    return ctx, cty, cinv


def test_mie_factor_of_a_rotated_camera_is_the_world_frame_formula(
        mie_scene):
    """photon_tpu/models/render.py:138-143: the chief direction rotated into
    the world frame by the inverse rotation and renormalised, dotted with
    the beam; and the JAX fast path's factor (its camera-frame dot,
    render_fast.py:690-712) differs from it."""
    image_distance, src, scat, setup = mie_scene
    inv = np.asarray(setup.inverse_rotation_matrix, np.float64)
    got = render_fast.mie_irradiance(image_distance, src, scat, inv)
    ctx, cty, cinv = _chief_dirs(image_distance, src)
    d = np.stack([ctx * cinv, cty * cinv, -cinv])
    w = np.einsum("ij,jp->ip", inv, d)
    w /= np.linalg.norm(w, axis=0)
    beam = np.asarray(scat["beam_propogation_vector"], np.float64)
    world = _lookup(scat, src, beam @ w)
    np.testing.assert_allclose(got, world, rtol=2e-7, atol=0)
    camera = _lookup(scat, src, beam[0] * ctx * cinv + beam[1] * cty * cinv
                     - beam[2] * cinv)
    moved = np.abs(camera / world - 1.0)
    print(f"JAX fast path's factor against the world frame's: up to "
          f"{moved.max():.3g} relative")
    assert moved.max() > 1e-2


def test_mie_factor_of_an_unrotated_camera_is_unchanged(mie_scene):
    """Bit for bit the JAX fast path's lines when the camera is not
    rotated, whether or not the identity is passed."""
    image_distance, src, scat, _ = mie_scene
    ctx, cty, cinv = _chief_dirs(image_distance, src)
    beam = np.asarray(scat["beam_propogation_vector"], np.float64)
    ref = _lookup(scat, src, beam[0] * ctx * cinv + beam[1] * cty * cinv
                  + beam[2] * (-cinv))
    np.testing.assert_array_equal(
        render_fast.mie_irradiance(image_distance, src, scat), ref)


def test_rotated_piv_render_takes_the_world_frame_factor(mie_scene,
                                                         monkeypatch):
    """render_image_fast hands the rotated camera's inverse rotation to the
    Mie factor, and none for an unrotated one."""
    image_distance, src, scat, setup = mie_scene
    seen = []
    real = render_fast.mie_irradiance

    def keep(*a):
        seen.append(a[3] if len(a) > 3 else None)
        return real(*a)

    monkeypatch.setattr(render_fast, "mie_irradiance", keep)
    from tests.test_torch_piv import golden_piv_config
    cfg = golden_piv_config()
    cfg.camera_design.x_camera_angle = 0.05
    tcfg = port_config(cfg)
    tsetup = camera_setup(tcfg)
    r = np.linspace(0.1, 0.9, 8).astype(np.float32)
    render_image_fast(tcfg, tsetup, src, r, r, scattering=scat,
                      device="cpu")
    render_image_fast(port_config(golden_piv_config()),
                      camera_setup(port_config(golden_piv_config())), src, r,
                      r, scattering=scat, device="cpu")
    np.testing.assert_array_equal(seen[0], tsetup.inverse_rotation_matrix)
    assert seen[1] is None
