"""Port vs JAX: the rest of the exact path's march menu on the CPU, on the
same seeded inputs: the adaptive RK45 (algorithm 3) and Adams-Bashforth
(algorithm 4) for rays from above and from below, pass-through and misses,
the cubic scheme, tests/test_march.py's oracle case, the differentiable
RK45 and its field gradient, gradient-index noise, the per-step recorder
of every algorithm, and run_simulation with the sample scene's camera.

Tolerances.  The JAX package run op by op (``jax.disable_jit``) and the
port evaluate the same float32 formulas in the same order, and the port
takes the same adaptive steps: rays within tests/test_torch_exact_march.py's
0.1 um and 1e-6, recordings with the same NaN pattern.  The jitted package
rounds fused expressions differently, and RK45's step control reads an
error estimate that on a linear field is rounding alone: there a ray can
accept, reject or freeze at another iteration (a "flip"), or a ray of any
integrator commit one step more at the exit.  Against the jitted package
the flipped rays are counted and printed with the largest gap they leave,
and the others are held at tests/test_march.py:173-184's tolerances
(positions rtol 1e-4, atol 1e-2 um; directions 1e-6).  Images: L1 within
1e-3 of the sum (tests/test_fast.py's budget).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import photon_tpu.ops.march as jmarch
from photon_tpu.pipeline import run_simulation as jax_run_simulation
from photon_tpu_torch import pipeline
from photon_tpu_torch.ops import march
from photon_tpu_torch.ops.lens import RayBundle
from tests.test_bos_pipeline import bos_case
from tests.test_march import make_gradient_volume, straight_rays
from tests.test_torch_exact_march import _assert_close, _both, _rays
from tests.test_torch_exact_render import _L1, _rotated_case, hold_image
from tests.test_torch_exact_render import exact_route  # noqa: F401 (fixture)
from tests.torch_port_helpers import port_config, port_volume, rel_l1

RTOL, POS_ATOL, DIR_ATOL = 1e-4, 1e-2, 1e-6    # tests/test_march.py:173-184


def _op_by_op(fn, *a, **kw):
    with jax.disable_jit():
        return fn(*a, **kw)


def _port_bundle(jax_bundle):
    return RayBundle(*(torch.tensor(np.asarray(a)) for a in jax_bundle))


def _hold_recording(got, ref):
    """(inter_pos, inter_dir) of the port against the JAX package's: the
    same shape and NaN pattern, finite values at the march's tolerances."""
    for g, r, atol in ((got[0], ref[0], 0.1), (got[1], ref[1], 1e-6)):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        fin = np.isfinite(r)
        assert fin.any()
        np.testing.assert_allclose(g[fin], r[fin], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def vol16():
    return make_gradient_volume(5.0, n=16)[0]


@pytest.mark.parametrize("algorithm", [3, 4])
@pytest.mark.parametrize("upward", [False, True])
def test_march_matches_jax_op_by_op(vol16, algorithm, upward):
    """RK45 and Adams-Bashforth for rays from above and from below (a
    camera rotated past 90 degrees) against the JAX package run op by op:
    every ray at the exact march's tolerances and every recorded iteration
    with the same NaN pattern, so every ray took the same steps."""
    rays = _rays(32, seed=1, upward=upward)
    jr, tr = _both(rays)
    ref, jrec = _op_by_op(jmarch.march_rays, vol16, jr, algorithm=algorithm,
                          record_steps=96, record_rays=32)
    got, trec = march.march_rays(port_volume(vol16), tr, algorithm=algorithm,
                                 record_steps=96, record_rays=32)
    moved = np.abs(np.asarray(ref.dir)[:, 0] - rays[1][:, 0]).max()
    assert moved > 1e-4, moved          # the volume deflects the rays
    _assert_close(got, ref)
    _hold_recording(trec, jrec)
    # every ray finished within the recording
    assert np.isnan(trec[0].numpy()[:, -1]).all()


@pytest.mark.parametrize("algorithm", [3, 4])
def test_flips_against_the_jitted_package(vol16, algorithm):
    """Against the JAX package's jitted march: the rays whose recorded
    steps differ (flips) are counted, with the largest gap of their exit
    positions; the others are held at tests/test_march.py's tolerances.
    At most a quarter of the rays may flip."""
    rays = _rays(48, seed=2)
    jr, tr = _both(rays)
    ref, (jp, jd) = jmarch.march_rays(vol16, jr, algorithm=algorithm,
                                      record_steps=96, record_rays=48)
    got, (tp, td) = march.march_rays(port_volume(vol16), tr,
                                     algorithm=algorithm, record_steps=96,
                                     record_rays=48)
    jp, tp = np.asarray(jp), tp.numpy()
    same = (np.isnan(jp) == np.isnan(tp)).all(axis=(1, 2))
    close = np.abs(np.nan_to_num(tp - jp)) <= POS_ATOL + RTOL * np.abs(
        np.nan_to_num(jp))
    flipped = ~(same & close.all(axis=(1, 2)))
    gpos, rpos = got.pos.numpy(), np.asarray(ref.pos)
    gap = float(np.abs(gpos - rpos)[flipped].max()) if flipped.any() else 0.0
    print(f"algorithm {algorithm}: {int(flipped.sum())} of {len(flipped)} "
          f"rays flipped against the jitted package; largest exit gap "
          f"{gap:.4g} um")
    keep = ~flipped
    assert keep.sum() >= 0.75 * len(keep)
    np.testing.assert_allclose(gpos[keep], rpos[keep], rtol=RTOL,
                               atol=POS_ATOL)
    np.testing.assert_allclose(got.dir.numpy()[keep],
                               np.asarray(ref.dir)[keep], rtol=RTOL,
                               atol=DIR_ATOL)


@pytest.mark.parametrize("algorithm", [3, 4])
def test_pass_through_and_miss(vol16, algorithm):
    """Zero gradient: rays exit undeviated, as the JAX package's; rays that
    miss the box come back unchanged, bit for bit."""
    flat, _, _ = make_gradient_volume(0.0, n=12)
    rays = _rays(8, seed=3, tilt=0.0)
    jr, tr = _both(rays)
    ref = _op_by_op(jmarch.march_rays, flat, jr, algorithm=algorithm)
    got = march.march_rays(port_volume(flat), tr, algorithm=algorithm)
    _assert_close(got, ref)
    np.testing.assert_allclose(got.dir.numpy()[:, 2], -1.0, atol=1e-6)
    miss = (np.array([[1e7, 1e7, -1e4], [-3e5, 0, 2e5]], np.float32),
            np.array([[0, 0, 1], [0, 0, -1]], np.float32),
            np.zeros(2, np.float32), np.ones(2, np.float32))
    jr, tr = _both(miss)
    got = march.march_rays(port_volume(vol16), tr, algorithm=algorithm)
    ref = jmarch.march_rays(vol16, jr, algorithm=algorithm)
    for a in (got.pos.numpy(), np.asarray(ref.pos)):
        np.testing.assert_array_equal(a, miss[0])
    np.testing.assert_array_equal(got.dir.numpy(), miss[1])


@pytest.mark.parametrize("algorithm", [3, 4])
def test_tricubic_matches_jax(algorithm):
    """The cubic scheme (the port prefilters in float32, the JAX package in
    float64: tests/test_torch_exact_ops.py holds the two to 2e-6 of the
    field) against the JAX package run op by op."""
    vol, _, _ = make_gradient_volume(3.0, n=14)
    jr, tr = _both(_rays(16, seed=5))
    ref = _op_by_op(jmarch.march_rays, vol, jr, algorithm=algorithm,
                    interpolation_scheme=2)
    got = march.march_rays(port_volume(vol), tr, algorithm=algorithm,
                           interpolation_scheme=2)
    _assert_close(got, ref)


@pytest.mark.parametrize("algorithm", [3, 4])
def test_uniform_gradient_oracle_matches_jax(algorithm):
    """tests/test_march.py:133-148's case: the port hits the paraxial
    deflection oracle at that test's tolerance (three steps of slack) and
    equals the JAX package run op by op."""
    grad_rho, extent, depth, rho0 = 5.0, 3e5, 1e5, 1.225
    vol, *_ = make_gradient_volume(grad_rho, n=24, extent=extent,
                                   depth=depth, rho0=rho0)
    jr = straight_rays(8, vol)
    ref = _op_by_op(jmarch.march_rays, vol, jr, algorithm=algorithm)
    got = march.march_rays(port_volume(vol), _port_bundle(jr),
                           algorithm=algorithm)
    _assert_close(got, ref)
    K = 0.225e-3
    n0 = 1.0 + K * (rho0 + grad_rho / 2.0)
    eps_expected = K * grad_rho / extent * depth / n0
    dirs = got.dir.numpy()
    eps = dirs[:, 0] / dirs[:, 2]
    np.testing.assert_allclose(eps[2:-2], eps_expected,
                               rtol=3.0 * vol.step_size / depth)


def test_differentiable_rk45_matches_while_loop():
    """The checkpointed fixed-step RK45 against the port's while loop at
    tests/test_march.py:173-184's tolerances."""
    vol, _, _ = make_gradient_volume(5.0, n=12)
    tr = _port_bundle(straight_rays(6, vol))
    pv = port_volume(vol)
    loop = march.march_rays(pv, tr, algorithm=3)
    scan = march.march_rays(pv, tr, algorithm=3, differentiable=True)
    np.testing.assert_allclose(scan.pos.numpy(), loop.pos.numpy(), rtol=RTOL,
                               atol=POS_ATOL)
    np.testing.assert_allclose(scan.dir.numpy(), loop.dir.numpy(), rtol=RTOL,
                               atol=DIR_ATOL)


def test_rk45_field_gradient_matches_jax():
    """The differentiable RK45's rays and d(sum of 1e3 x exit x
    directions)/d(field) (tests/test_march.py:186-211's loss) against
    ``jax.vjp`` of the JAX package's scan run op by op: the rays at the
    exact march's tolerances, the gradient at cosine >= 0.9999 and relative
    L2 within 1e-3 (tests/test_torch_exact_march.py's measures).  24 steps
    cover the march: the while loop's rays equal the scan's."""
    vol, _, _ = make_gradient_volume(5.0, n=12)
    jr = straight_rays(6, vol)
    flat = np.asarray(vol.field).reshape(-1, 4)
    with jax.disable_jit():
        ref, vjp = jax.vjp(lambda f: jmarch.march_rays(
            vol, jr, algorithm=3, differentiable=True, num_steps=24,
            field_flat=f), jnp.asarray(flat))
        ct = jax.tree_util.tree_map(jnp.zeros_like, ref)
        ct = ct._replace(dir=ct.dir.at[:, 0].set(1e3))
        (g_ref,) = vjp(ct)
    g_ref = np.asarray(g_ref, np.float64)
    field = torch.tensor(flat, requires_grad=True)
    out = march.march_rays(port_volume(vol), _port_bundle(jr), algorithm=3,
                           differentiable=True, num_steps=24,
                           field_flat=field)
    (out.dir[:, 0] * 1e3).sum().backward()
    with torch.no_grad():
        _assert_close(out, ref)
    got = field.grad.numpy().astype(np.float64)
    assert np.isfinite(got).all() and np.abs(g_ref).sum() > 0
    cos = float((got * g_ref).sum() / np.linalg.norm(got)
                / np.linalg.norm(g_ref))
    rel = float(np.linalg.norm(got - g_ref) / np.linalg.norm(g_ref))
    print(f"d_field: cosine {cos:.8f}, relative L2 {rel:.3g}")
    assert cos >= 0.9999 and rel <= 1e-3
    loop = march.march_rays(port_volume(vol), _port_bundle(jr), algorithm=3)
    np.testing.assert_allclose(out.dir.detach().numpy(), loop.dir.numpy(),
                               rtol=RTOL, atol=DIR_ATOL)


def test_gradient_index_noise():
    """Adams-Bashforth draws noise only in its three RK4 starting steps:
    at std 0 it equals the noiseless march bit for bit, and a nonzero std
    moves it.  RK45 takes no noise, in the JAX package as here: with noise
    on it equals the noiseless march, and the JAX package's."""
    vol12 = make_gradient_volume(5.0, n=12)[0]
    jr, tr = _both(_rays(24, seed=9))
    vol = port_volume(vol12)
    plain = march.march_rays(vol, tr, algorithm=4)
    for std, same in ((0.0, True), (2e-9, False)):
        noisy = march.march_rays(vol, tr, algorithm=4, add_ngrad_noise=True,
                                 ngrad_noise_std=std, seed=3)
        assert torch.equal(noisy.dir, plain.dir) is same
        assert torch.equal(noisy.pos, plain.pos) is same
    kw = dict(algorithm=3, add_ngrad_noise=True, ngrad_noise_std=2e-9,
              seed=3)
    noisy = march.march_rays(vol, tr, **kw)
    plain = march.march_rays(vol, tr, algorithm=3)
    assert torch.equal(noisy.pos, plain.pos)
    assert torch.equal(noisy.dir, plain.dir)
    _assert_close(noisy, _op_by_op(jmarch.march_rays, vol12, jr, **kw))


@pytest.mark.parametrize("algorithm", [1, 2, 3, 4])
def test_recorder_matches_jax(algorithm):
    """tests/test_intermediate_rays.py:26-58's case: the port's recording
    of 4 rays for 40 iterations against the JAX package's (run op by op):
    (n_rec, S, 3) shapes, the same NaN pattern, finite values at the exact
    march's tolerances, and the final bundle."""
    from tests.test_bos_pipeline import gradient_volume_between
    from tests.test_intermediate_rays import _rays as recorder_rays
    from photon_tpu.models.optics import camera_setup
    vol, *_ = gradient_volume_between(camera_setup(bos_case("general")),
                                      n=16)
    jr = recorder_rays()
    ref, jrec = _op_by_op(jmarch.march_rays, vol, jr, algorithm=algorithm,
                          record_steps=40, record_rays=4)
    got, trec = march.march_rays(port_volume(vol), _port_bundle(jr),
                                 algorithm=algorithm, record_steps=40,
                                 record_rays=4)
    assert trec[0].shape == trec[1].shape == (4, 40, 3)
    _assert_close(got, ref)
    _hold_recording(trec, jrec)
    assert np.isfinite(trec[0].numpy()[:, :3]).all()


def test_recorder_refuses_the_differentiable_loop(vol16):
    _, tr = _both(_rays(4, seed=4))
    for algorithm in (2, 3):
        with pytest.raises(ValueError):
            march.march_rays(port_volume(vol16), tr, algorithm=algorithm,
                             differentiable=True, num_steps=8,
                             record_steps=10)


@pytest.mark.parametrize("algorithm", [3, 4])
def test_run_simulation_sample_camera_matches_jax(tmp_path, exact_route,
                                                  algorithm):
    """The sample scene's camera (rotated by 5 pi / 6, the thin lens) with a
    volume its world-frame rays cross, through run_simulation with RK45 or
    Adams-Bashforth: both images on the exact path, held to the JAX package
    run op by op at the budget, and to its jitted run no farther than the
    op-by-op run is, plus the budget (RK45's flips move the jitted im2 by
    about 2.4e-3)."""
    cfg = bos_case("thin-lens", n_dots=4, rays=16)
    cfg.camera_design.x_pixel_number = 128
    cfg.camera_design.y_pixel_number = 96
    cfg.density_gradients.ray_tracing_algorithm = algorithm
    cfg = _rotated_case(tmp_path, cfg, cfg.bos_pattern.X_Max)
    jitted = jax_run_simulation(cfg, rng=np.random.default_rng(11))
    ref = _op_by_op(jax_run_simulation, cfg, rng=np.random.default_rng(11))
    got = pipeline.run_simulation(port_config(cfg),
                                  rng=np.random.default_rng(11),
                                  device="cpu")
    assert exact_route == [False, True]
    for name in ref.raw_images:
        print(name)
        hold_image(got.raw_images[name], ref.raw_images[name])
        spread = rel_l1(ref.raw_images[name], jitted.raw_images[name])
        d = rel_l1(got.raw_images[name], jitted.raw_images[name])
        print(f"    against the jitted run: L1 {d:.3g} (op by op: "
              f"{spread:.3g})")
        assert d <= spread + _L1, (d, spread)
    im1, im2 = (got.raw_images[n] for n in sorted(got.raw_images))
    assert rel_l1(im2, im1) > 1e-2
