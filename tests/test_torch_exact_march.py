"""Port vs JAX: the exact path's march (``ops/march.py``) on the CPU, on the
same seeded inputs: the AABB entry, Euler and RK4 for rays entering from
above and from below, the stale-sample fallback, pass-through and misses,
the cubic scheme, the differentiable loop and its field gradient,
gradient-index noise, and make_march_fn / record_steps across the menu
(RK45 and Adams-Bashforth in depth: tests/test_torch_exact_menu.py).

Tolerances.  Both sides run the same float32 formulas in the same order;
the JAX package's CPU ``sqrt`` (RK4's renormalisation) is not always the
correctly rounded one, so exit directions differ by a few ulp and positions
by a few ulp of their ~1e5 um coordinates (one ulp is 7.8e-3 um): positions
within 0.1 um (3.3e-7 of the 3e5 um volume), directions within 1e-6 (the
directions' tolerance of
tests/test_march.py::test_differentiable_scan_matches_while).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import photon_tpu.ops.march as jmarch
from photon_tpu.ops.lens import RayBundle as JaxBundle
from photon_tpu.volume import build_density_volume
from photon_tpu_torch.ops import march
from photon_tpu_torch.ops.lens import RayBundle
from tests.test_march import make_gradient_volume
from tests.torch_port_helpers import port_volume

POS_ATOL, DIR_ATOL = 0.1, 1e-6


def _rays(n, seed=0, upward=False, z_start=-1e4, depth=1e5, spread=5e4,
          tilt=0.02):
    """``n`` rays with seeded lateral positions and slopes, travelling -z
    from above the volume or (``upward``) +z from below it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-spread, spread, n)
    y = rng.uniform(-spread, spread, n)
    d = np.stack([rng.uniform(-tilt, tilt, n), rng.uniform(-tilt, tilt, n),
                  np.ones(n)], -1)
    z = np.full(n, z_start)
    if not upward:
        d[:, 2] = -1.0
        z = np.full(n, depth - z_start)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    pos = np.stack([x, y, z], -1)
    return (np.ascontiguousarray(pos, np.float32),
            np.ascontiguousarray(d, np.float32),
            np.zeros(n, np.float32), np.ones(n, np.float32))


def _both(rays):
    return (JaxBundle(*(jnp.asarray(a) for a in rays)),
            RayBundle(*(torch.tensor(a) for a in rays)))


def _march_both(jvol, rays, **kw):
    jr, tr = _both(rays)
    ref = jmarch.march_rays(jvol, jr, **kw)
    got = march.march_rays(port_volume(jvol), tr, **kw)
    return got, ref


def _assert_close(got, ref, pos_atol=POS_ATOL, dir_atol=DIR_ATOL):
    for name, g, r, atol in (("pos", got.pos, ref.pos, pos_atol),
                             ("dir", got.dir, ref.dir, dir_atol)):
        g, r = g.numpy(), np.asarray(r)
        err = np.abs(g - r).max()
        print(f"    {name}: max difference {err:.3g}")
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def vol32():
    vol, _, _ = make_gradient_volume(5.0, n=32)
    return vol


def test_aabb_entry_matches_jax():
    """tests/test_march.py::test_aabb_entry's rays, rays that travel upward
    into the box from below, and seeded rays from every side."""
    lo = np.zeros(3, np.float32)
    hi = np.full(3, 10.0, np.float32)
    rng = np.random.default_rng(4)
    pos = np.concatenate([
        np.array([[5, 5, -3], [20, 5, -3], [5, 5, 5], [5, 5, 13],
                  [5, 5, -3]], np.float32),
        rng.uniform(-5, 15, (200, 3)).astype(np.float32)])
    d = np.concatenate([
        np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, -1],
                  [0.2, 0.1, 1]], np.float32),
        rng.normal(0, 1, (200, 3)).astype(np.float32)])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jp, jh = jmarch.aabb_entry(jnp.asarray(pos), jnp.asarray(d),
                               jnp.asarray(lo), jnp.asarray(hi))
    tp, th = march.aabb_entry(torch.tensor(pos), torch.tensor(d),
                              torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    assert th[0] and not th[1] and th[4]
    np.testing.assert_allclose(tp[0].numpy(), [5, 5, 0], atol=1e-5)
    # the upward ray from below enters through z = 0
    assert abs(float(tp[4, 2])) < 1e-5 and float(tp[4, 0]) > 5.0


@pytest.mark.parametrize("algorithm", [1, 2])
@pytest.mark.parametrize("upward", [False, True])
def test_march_matches_jax(vol32, algorithm, upward):
    """Euler and RK4 through a uniform-gradient volume for rays entering
    from above (travelling -z) and from below (+z: a camera rotated by
    90 degrees or more), against the JAX package's march_rays."""
    rays = _rays(48, seed=1, upward=upward)
    got, ref = _march_both(vol32, rays, algorithm=algorithm)
    moved = np.abs(np.asarray(ref.dir)[:, 0] - rays[1][:, 0]).max()
    assert moved > 1e-4, moved          # the volume deflects the rays
    _assert_close(got, ref)


@pytest.mark.parametrize("algorithm", [1, 2])
def test_fallback_branches_match_jax(algorithm):
    """A field whose gradient varies (rho quadratic in x and y), with the
    volume's minimum of n - 1 raised to the field's median: samples below
    it take both branches of the stale-sample fallback (the first step
    refetches one slab back, later steps reuse the previous sample)."""
    n, extent, depth = 24, 3e5, 1e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z = np.linspace(0.0, depth, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    rho = 1.225 + 4.0 * ((X / extent) ** 2 + (Y / extent) ** 2)[..., None] \
        * np.ones((1, 1, n))
    vol = build_density_volume(rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]],
                               [x[0], x[0], z[0]], z_origin_shift=0.0)
    median = float(np.median(np.asarray(vol.field)[..., 3]))
    jvol = vol._replace(data_min=median)
    rays = _rays(64, seed=2, spread=1.2e5, tilt=0.05)
    got, ref = _march_both(jvol, rays, algorithm=algorithm)
    _assert_close(got, ref)
    # the raised minimum changes the march (the fallbacks were taken)
    plain = jmarch.march_rays(vol, _both(rays)[0], algorithm=algorithm)
    assert np.abs(np.asarray(plain.dir) - np.asarray(ref.dir)).max() > 1e-6


def test_pass_through_and_miss(vol32):
    """Zero gradient: rays exit undeviated; rays that miss the box come
    back unchanged, bit for bit."""
    flat, _, _ = make_gradient_volume(0.0, n=16)
    rays = _rays(8, seed=3, tilt=0.0)
    got, ref = _march_both(flat, rays, algorithm=2)
    _assert_close(got, ref)
    np.testing.assert_allclose(got.dir.numpy()[:, 2], -1.0, atol=1e-6)
    miss = (np.array([[1e7, 1e7, -1e4], [-3e5, 0, 2e5]], np.float32),
            np.array([[0, 0, 1], [0, 0, -1]], np.float32),
            np.zeros(2, np.float32), np.ones(2, np.float32))
    got, ref = _march_both(vol32, miss, algorithm=2)
    np.testing.assert_array_equal(got.pos.numpy(), miss[0])
    np.testing.assert_array_equal(got.dir.numpy(), miss[1])
    np.testing.assert_array_equal(np.asarray(ref.pos), miss[0])


@pytest.mark.parametrize("algorithm", [1, 2])
def test_tricubic_march_matches_jax(algorithm):
    """The cubic scheme: the port prefilters in float32 on the device, the
    JAX exact path in float64 numpy (tests/test_torch_exact_ops.py holds the
    two prefilters to 2e-6 of the field); the march's tolerances hold."""
    vol, _, _ = make_gradient_volume(3.0, n=20)
    rays = _rays(24, seed=5)
    got, ref = _march_both(vol, rays, algorithm=algorithm,
                           interpolation_scheme=2)
    _assert_close(got, ref)


def test_differentiable_matches_while_loop(vol32):
    """``differentiable=True`` (checkpointed fixed-step loop) against the
    port's while loop, and against the JAX package's scan, at
    tests/test_march.py's tolerances (pos rtol 1e-4 atol 1e-2, dir rtol
    1e-4 atol 1e-6)."""
    rays = _rays(16, seed=6)
    _, tr = _both(rays)
    vol = port_volume(vol32)
    loop = march.march_rays(vol, tr, algorithm=2)
    scan = march.march_rays(vol, tr, algorithm=2, differentiable=True)
    np.testing.assert_allclose(scan.pos.numpy(), loop.pos.numpy(),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(scan.dir.numpy(), loop.dir.numpy(),
                               rtol=1e-4, atol=1e-6)
    ref = jmarch.march_rays(vol32, _both(rays)[0], algorithm=2,
                            differentiable=True)
    _assert_close(scan, ref)


@pytest.mark.parametrize("algorithm", [1, 2])
def test_field_gradient_matches_jax_grad(algorithm):
    """d(sum of exit x positions and directions)/d(field) through
    ``differentiable=True`` against ``jax.grad`` (tests/test_march.py
    :214-229's loss, plus the directions): cosine >= 0.9999 and relative L2
    within 1e-3."""
    jvol, _, _ = make_gradient_volume(5.0, n=12)
    rays = _rays(8, seed=7, spread=4e4)
    jr, tr = _both(rays)
    flat = np.asarray(jvol.field).reshape(-1, 4)

    def jloss(field):
        out = jmarch.march_rays(jvol, jr, algorithm=algorithm,
                                differentiable=True, num_steps=64,
                                field_flat=field)
        return jnp.sum(out.pos[:, 0]) + 1e5 * jnp.sum(out.dir[:, 0])

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(flat)), np.float64)
    field = torch.tensor(flat, requires_grad=True)
    out = march.march_rays(port_volume(jvol), tr, algorithm=algorithm,
                           differentiable=True, num_steps=64,
                           field_flat=field)
    (out.pos[:, 0].sum() + 1e5 * out.dir[:, 0].sum()).backward()
    got = field.grad.numpy().astype(np.float64)
    assert np.isfinite(got).all() and np.abs(ref).sum() > 0
    cos = float((got * ref).sum() / np.linalg.norm(got) / np.linalg.norm(ref))
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"d_field: cosine {cos:.8f}, relative L2 {rel:.3g}")
    assert cos >= 0.9999 and rel <= 1e-3


def test_make_march_fn_and_slice_b_raise(vol32):
    """make_march_fn at the cubic scheme; algorithms 3 (RK45) and 4
    (Adams-Bashforth) through make_march_fn, and ``record_steps`` through
    march_rays, against the JAX package's (RK45 against its run op by op,
    whose adaptive steps the port repeats: tests/test_torch_exact_menu.py);
    an unknown algorithm raises ValueError."""
    rays = _rays(8, seed=8)
    jr, tr = _both(rays)
    vol = port_volume(vol32)
    fn = march.make_march_fn(vol, algorithm=2, interpolation_scheme=2)
    ref = jmarch.make_march_fn(vol32, algorithm=2, interpolation_scheme=2)(jr)
    _assert_close(fn(tr), ref)
    for algorithm in (3, 4):
        with jax.disable_jit():
            ref = jmarch.make_march_fn(vol32, algorithm=algorithm)(jr)
        _assert_close(march.make_march_fn(vol, algorithm=algorithm)(tr), ref)
    got, (gpos, gdir) = march.march_rays(vol, tr, record_steps=4)
    ref, (rpos, rdir) = jmarch.march_rays(vol32, jr, record_steps=4)
    _assert_close(got, ref)
    assert gpos.shape == gdir.shape == (8, 4, 3)
    for g, r, atol in ((gpos, rpos, POS_ATOL), (gdir, rdir, DIR_ATOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=atol)
    with pytest.raises(ValueError):
        march.march_rays(vol, tr, algorithm=5)


# ---------------------------------------------------------------------------
# gradient-index noise: the JAX package's draws cannot be repeated
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", [1, 2])
@pytest.mark.parametrize("differentiable", [False, True])
def test_noise_of_std_zero_is_the_noiseless_march(vol32, algorithm,
                                                  differentiable):
    rays = _rays(32, seed=9)
    _, tr = _both(rays)
    vol = port_volume(vol32)
    kw = dict(algorithm=algorithm, differentiable=differentiable)
    plain = march.march_rays(vol, tr, **kw)
    noisy = march.march_rays(vol, tr, add_ngrad_noise=True,
                             ngrad_noise_std=0.0, seed=3, **kw)
    assert torch.equal(noisy.pos, plain.pos)
    assert torch.equal(noisy.dir, plain.dir)


@pytest.mark.parametrize("algorithm", [1, 2])
def test_noise_spread_matches_jax(vol32, algorithm):
    """At the same std the exit directions spread about the noiseless ones
    as the JAX package's do: 600 rays, the spread (RMS over rays and x, y)
    of each package within 15% of the other (each estimate's own sampling
    error is ~2%); the two draws differ."""
    rays = _rays(600, seed=10)
    jr, tr = _both(rays)
    vol = port_volume(vol32)
    std = 2e-9          # half the volume's grad n (3.7e-9 per um)
    spreads = []
    for run, bundle, v in ((jmarch.march_rays, jr, vol32),
                           (march.march_rays, tr, vol)):
        plain = np.asarray(run(v, bundle, algorithm=algorithm).dir)
        noisy = np.asarray(run(v, bundle, algorithm=algorithm,
                               add_ngrad_noise=True, ngrad_noise_std=std,
                               seed=11).dir)
        spreads.append(float(np.sqrt(np.mean((noisy - plain)[:, :2] ** 2))))
    print(f"exit-direction spread: JAX {spreads[0]:.4g}, port "
          f"{spreads[1]:.4g}")
    assert spreads[0] > 0 and abs(spreads[1] / spreads[0] - 1.0) <= 0.15
