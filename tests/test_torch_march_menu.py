"""Port vs JAX: the rest of the dense march's menu on the CPU.

Tricubic interpolation (scheme 2) with its B-spline prefilter, Adams-Bashforth
(algorithm 4), the gradients of both and of RK4 with substeps, and
``choose_substeps``.  The port's side is the plain march (``march_chief_dense``
and what ``march_chief_fused`` does with CPU tensors); the JAX side is
``photon_tpu.ops.march_dense`` with the XLA sampler (``use_pallas_sampler=
False``), the oracle of the JAX package's own tests.  Volume and rays are those
of tests/test_dense_fused.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.ops.march_dense import (bspline_prefilter_jax,
                                        choose_substeps as jax_choose,
                                        march_chief_dense as jax_march)
from photon_tpu.volume import build_density_volume
from photon_tpu_torch.ops import march_dense as md
from photon_tpu_torch.ops import march_dense_fused as mdf
from photon_tpu_torch.ops import march_dense_sampler as mds
from photon_tpu_torch.ops.march_dense import (bspline_prefilter,
                                              choose_substeps,
                                              march_chief_dense,
                                              march_chief_per_stage)
from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
from tests.test_torch_march import _close, _scale
from tests.torch_port_helpers import port_volume


def _vol(n=12, lo=-6e4, hi=6e4, z0=4.0e5, z1=9.0e5):
    rng = np.random.default_rng(3)
    x = np.linspace(lo, hi, n)
    z = np.linspace(z0, z1, n)
    rho = 1.2 + 0.8 * rng.random((n, n, n))
    return build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [lo, lo, z0])


def _chiefs(p=37, seed=0, spread=4e4):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-spread, spread, p).astype(np.float32)
    ys = rng.uniform(-spread, spread, p).astype(np.float32)
    zs = np.full(p, 1.0e6, np.float32)
    tx = rng.uniform(-0.08, 0.08, p)
    ty = rng.uniform(-0.08, 0.08, p)
    inv = 1.0 / np.sqrt(tx * tx + ty * ty + 1.0)
    return (xs, ys, zs, (tx * inv).astype(np.float32),
            (ty * inv).astype(np.float32), (-inv).astype(np.float32))


def _normalised_err(got, ref):
    denom = np.abs(ref).max()
    assert denom > 0
    return float(np.abs(got - ref).max() / denom)


# ---------------------------------------------------------------------------
# (a) the prefilter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_field():
    # shorter than the 12-term horizon along two axes, longer along one
    return np.random.default_rng(7).normal(size=(7, 15, 9, 4)).astype(
        np.float32)


def test_prefilter_matches_jax(raw_field):
    """1e-6 of the largest coefficient: both run the same f32 recurrences."""
    ref = np.asarray(bspline_prefilter_jax(jnp.asarray(raw_field)))
    got = bspline_prefilter(torch.from_numpy(raw_field))
    assert got.is_contiguous() and got.shape == raw_field.shape
    err = _normalised_err(got.numpy(), ref)
    print(f"prefilter: {err:.3g} of the maximum")
    assert err <= 1e-6


def test_prefilter_transpose_matches_jax_vjp(raw_field):
    ct = np.random.default_rng(8).normal(size=raw_field.shape).astype(
        np.float32)
    _, vjp = jax.vjp(bspline_prefilter_jax, jnp.asarray(raw_field))
    ref = np.asarray(vjp(jnp.asarray(ct))[0])
    f = torch.from_numpy(raw_field).requires_grad_(True)
    bspline_prefilter(f).backward(torch.from_numpy(ct))
    err = _normalised_err(f.grad.numpy(), ref)
    print(f"prefilter transpose: {err:.3g} of the maximum")
    assert err <= 1e-6


def test_prefilter_interpolates_the_samples():
    """Cubic B-spline coefficients reproduce the samples at voxel centres
    (weights 1/6, 4/6, 1/6), away from the borders."""
    f = torch.from_numpy(np.random.default_rng(9).normal(
        size=(20, 3, 3, 1)).astype(np.float32))
    c = md._prefilter_axis(f, 0)
    back = (c[:-2] + 4.0 * c[1:-1] + c[2:]) / 6.0
    np.testing.assert_allclose(back[4:-4].numpy(), f[5:-5].numpy(),
                               atol=2e-6)


# ---------------------------------------------------------------------------
# (c) the march, forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    jv = _vol()
    return jv, port_volume(jv)


MENU = [(1, 2), (2, 2), (3, 2), (4, 1), (4, 2)]


@pytest.mark.parametrize("entry", ["dense", "fused"])
@pytest.mark.parametrize("algorithm,scheme", MENU)
def test_menu_matches_jax(scene, algorithm, scheme, entry):
    """Tolerance of tests/test_torch_march.py (``_close``: rtol 2e-4, positions
    to 4 eps of the largest coordinate, directions to 2e-6)."""
    jv, tv = scene
    rays = _chiefs()
    # rays that leave the volume sideways reach the cubic clamp and folds
    rays[0][:4] = [-7.4e4, 7.3e4, -9.0e4, 9.5e4]
    ref = jax_march(jv, *(jnp.asarray(a) for a in rays), algorithm=algorithm,
                    interpolation_scheme=scheme, use_pallas_sampler=False)
    fn = march_chief_dense if entry == "dense" else march_chief_fused
    got = fn(tv, *(torch.from_numpy(a) for a in rays), algorithm=algorithm,
             interpolation_scheme=scheme)
    _close([g.numpy() for g in got], ref,
           f"alg {algorithm} scheme {scheme} {entry}", _scale(jv))


def test_menu_cases_differ_from_each_other(scene):
    """The comparisons above are not of one march under five names."""
    _, tv = scene
    rays = [torch.from_numpy(a) for a in _chiefs()]
    outs = {k: march_chief_dense(tv, *rays, algorithm=k[0],
                                 interpolation_scheme=k[1])[3]
            for k in MENU + [(2, 1)]}
    for a, b in (((2, 2), (2, 1)), ((4, 1), (2, 1)), ((4, 2), (2, 2)),
                 ((1, 2), (2, 2)), ((3, 2), (2, 2))):
        assert float((outs[a] - outs[b]).abs().max()) > 1e-8, (a, b)


def test_per_stage_entry_equals_plain_march_on_the_cpu(scene):
    _, tv = scene
    rays = [torch.from_numpy(a) for a in _chiefs(p=9)]
    for alg, scheme in ((4, 2), (3, 1)):
        a = march_chief_dense(tv, *rays, algorithm=alg,
                              interpolation_scheme=scheme)
        b = march_chief_per_stage(tv, *rays, algorithm=alg,
                                  interpolation_scheme=scheme)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kw", [dict(interpolation_scheme=3),
                                dict(interpolation_scheme=0),
                                dict(algorithm=5), dict(algorithm=0)])
@pytest.mark.parametrize("entry", ["dense", "fused", "per_stage"])
def test_unknown_scheme_or_algorithm_raises(scene, entry, kw):
    _, tv = scene
    fn = dict(dense=march_chief_dense, fused=march_chief_fused,
              per_stage=march_chief_per_stage)[entry]
    with pytest.raises(ValueError, match="unknown"):
        fn(tv, *(torch.from_numpy(a) for a in _chiefs(p=4)), **kw)


# ---------------------------------------------------------------------------
# (d) gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    jv = _vol(n=8)
    return jv, port_volume(jv), _chiefs(9)


GRADS = {
    # (algorithm, scheme, substeps): limit, of the largest gradient; the
    # limits of tests/test_dense_fused.py (:233 tricubic, :284 substeps)
    "tricubic RK4": (2, 2, None, 1e-3),
    "tricubic Euler": (1, 2, None, 1e-3),
    "trilinear RK4 x 3 substeps": (3, 1, 3, 5e-4),
    "AB4 trilinear": (4, 1, None, 5e-4),
}


@pytest.mark.parametrize("case", sorted(GRADS))
def test_field_gradient_matches_jax(small, case):
    jv, tv, rays = small
    algorithm, scheme, substeps, limit = GRADS[case]
    jrays = tuple(jnp.asarray(a) for a in rays)

    def loss(field):
        out = jax_march(jv, *jrays, algorithm=algorithm, field=field,
                        interpolation_scheme=scheme, substeps=substeps,
                        use_pallas_sampler=False)
        return jnp.sum(out[1] ** 2 + out[4] ** 2 * 1e6)

    ref = np.asarray(jax.grad(loss)(jv.field))
    field = tv.field.clone().requires_grad_(True)
    out = march_chief_fused(tv._replace(field=field),
                            *(torch.from_numpy(a) for a in rays),
                            algorithm=algorithm, interpolation_scheme=scheme,
                            substeps=substeps)
    torch.sum(out[1] ** 2 + out[4] ** 2 * 1e6).backward()
    err = _normalised_err(field.grad.numpy(), ref)
    print(f"{case}: d_field {err:.3g} of its maximum (limit {limit:g})")
    assert err <= limit


@pytest.mark.parametrize("algorithm,scheme", [(2, 2), (4, 1)])
def test_entry_state_gradients_match_jax(small, algorithm, scheme):
    """Cotangents of the entry position and direction, 1e-3 of the largest
    (tests/test_dense_fused.py:109-132)."""
    jv, tv, (xs, ys, zs, dx, dy, dz) = small

    def jax_run(args):
        x, t = args
        o = jax_march(jv, x, jnp.asarray(ys), jnp.asarray(zs), t,
                      jnp.asarray(dy), jnp.asarray(dz), algorithm=algorithm,
                      interpolation_scheme=scheme, use_pallas_sampler=False)
        return jnp.sum(o[0]) + 1e6 * jnp.sum(o[3])

    ref = jax.grad(jax_run)((jnp.asarray(xs), jnp.asarray(dx)))
    x = torch.from_numpy(xs).requires_grad_(True)
    t = torch.from_numpy(dx).requires_grad_(True)
    o = march_chief_fused(tv, x, torch.from_numpy(ys), torch.from_numpy(zs),
                          t, torch.from_numpy(dy), torch.from_numpy(dz),
                          algorithm=algorithm, interpolation_scheme=scheme)
    (torch.sum(o[0]) + 1e6 * torch.sum(o[3])).backward()
    for got, r in zip((x.grad, t.grad), ref):
        assert _normalised_err(got.numpy(), np.asarray(r)) <= 1e-3


@pytest.mark.parametrize("algorithm,scheme", [(2, 2), (4, 1), (4, 2)])
def test_rays_that_never_march_give_finite_gradients(small, algorithm,
                                                     scheme):
    """Upward rays, a ray below the volume and a horizontal ray share the
    batch: the field's gradient stays finite (no 0 * inf through a gate)."""
    _, tv, rays = small
    rays = [a.copy() for a in rays]
    rays[5][::3] *= -1.0
    rays[2][1] = 3.0e5
    rays[3][4], rays[4][4], rays[5][4] = 1.0, 0.0, 0.0
    field = tv.field.clone().requires_grad_(True)
    out = march_chief_fused(tv._replace(field=field),
                            *(torch.from_numpy(a) for a in rays),
                            algorithm=algorithm, interpolation_scheme=scheme)
    sum((o ** 2).sum() for o in out).backward()
    assert torch.isfinite(field.grad).all() and field.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# (e) choose_substeps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sheet():
    """The steep Gaussian z-sheet of tests/test_march_dense.py:78-96."""
    n, d = 24, 12
    extent, z0, z1 = 2.4e5, 4.0e5, 9.0e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z = np.linspace(z0, z1, d)
    dzs = z[1] - z[0]
    zc = 0.5 * (z0 + z1) + 0.37 * dzs
    sh = np.exp(-((z - zc) / (0.25 * dzs)) ** 2)
    gx = (x - x.min()) / (x.max() - x.min())
    rho = 1.225 + 12.0 * gx[:, None, None] * sh[None, None, :] \
        * np.ones((1, n, 1))
    jv = build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], dzs], [x[0], x[0], z0])
    P = 17
    xs = np.linspace(-0.8e5, 0.8e5, P).astype(np.float32)
    rays = (xs, np.zeros(P, np.float32), np.full(P, 1.0e6, np.float32),
            np.zeros(P, np.float32), np.zeros(P, np.float32),
            np.full(P, -1.0, np.float32))
    return jv, port_volume(jv), rays


@pytest.mark.parametrize("kw", [dict(), dict(budget=1e-12),
                                dict(budget=1e-6, max_substeps=64),
                                dict(sample=5)])
def test_choose_substeps_matches_jax(sheet, kw):
    jv, tv, rays = sheet
    want = jax_choose(jv, *(jnp.asarray(a) for a in rays), **kw)
    got = choose_substeps(tv, *(torch.from_numpy(a) for a in rays), **kw)
    print(f"choose_substeps({kw}): {got} (JAX package: {want})")
    assert got == want
    if kw == dict(budget=1e-12):
        assert got == 16


def test_choose_substeps_ignores_autograd_and_refuses_large_slabs(sheet):
    _, tv, rays = sheet
    field = tv.field.clone().requires_grad_(True)
    ts = [torch.from_numpy(a) for a in rays]
    n = choose_substeps(tv._replace(field=field), *ts)
    assert n == choose_substeps(tv, *ts) and field.grad is None
    big = tv._replace(field=torch.zeros((3, 300, 300, 4)))
    with pytest.raises(NotImplementedError, match="Large volumes"):
        choose_substeps(big, *ts)


# ---------------------------------------------------------------------------
# (g) which route a tensor off the CPU takes (meta tensors for the card)
# ---------------------------------------------------------------------------

class _Reached(Exception):
    pass


@pytest.fixture
def meta_scene(small, monkeypatch):
    _, tv, rays = small
    calls = []

    def sampler_kernel(lo, hi, ux, uy, uz, scheme):
        calls.append(scheme)
        raise _Reached

    monkeypatch.setattr(mds, "slab_sample_forward", sampler_kernel)
    field = torch.empty_like(tv.field, device="meta")
    ts = [torch.empty(len(a), device="meta") for a in rays]
    return tv._replace(field=field), ts, calls


@pytest.mark.parametrize("scheme", [1, 2])
def test_card_route_of_ab4_reaches_the_sampler_kernel(meta_scene, scheme):
    vol, ts, calls = meta_scene
    with pytest.raises(_Reached):
        march_chief_fused(vol, *ts, algorithm=4, interpolation_scheme=scheme)
    assert calls == [scheme]


def test_card_route_of_substeps_with_gradient_reaches_the_sampler_kernel(
        meta_scene):
    vol, ts, calls = meta_scene
    vol = vol._replace(field=vol.field.requires_grad_(True))
    with pytest.raises(_Reached):
        march_chief_fused(vol, *ts, algorithm=3, substeps=2)
    assert calls == [1]


@pytest.mark.parametrize("algorithm,scheme,substeps",
                         [(1, 1, None), (2, 2, None), (3, 1, 2), (3, 2, 4)])
def test_card_route_without_gradient_reaches_the_fused_kernel(
        meta_scene, monkeypatch, algorithm, scheme, substeps):
    """Euler, RK4 and RK4 with substeps without gradients: the fused march
    kernel (its library load stands for it here), not the sampler."""
    vol, ts, calls = meta_scene

    def load(name):
        raise _Reached(name)

    monkeypatch.setattr(mdf.kernels, "load", load)
    with pytest.raises(_Reached, match="march_dense"):
        march_chief_fused(vol, *ts, algorithm=algorithm,
                          interpolation_scheme=scheme, substeps=substeps)
    assert calls == []


@pytest.mark.parametrize("algorithm,scheme", [(2, 1), (1, 2)])
def test_card_route_of_rk4_and_euler_with_gradient_reaches_the_residual_head(
        meta_scene, monkeypatch, algorithm, scheme):
    vol, ts, calls = meta_scene
    vol = vol._replace(field=vol.field.requires_grad_(True))

    def load(name):
        raise _Reached(name)

    monkeypatch.setattr(mdf.kernels, "load", load)
    with pytest.raises(_Reached, match="march_dense"):
        march_chief_fused(vol, *ts, algorithm=algorithm,
                          interpolation_scheme=scheme)
    assert calls == []


@pytest.mark.parametrize("algorithm,scheme", MENU)
def test_plain_march_never_reaches_a_kernel(meta_scene, monkeypatch,
                                            algorithm, scheme):
    """``march_chief_dense`` is the plain version on any device."""
    vol, ts, calls = meta_scene

    def load(name):
        raise _Reached(name)

    monkeypatch.setattr(mdf.kernels, "load", load)
    out = march_chief_dense(vol, *ts, algorithm=algorithm,
                            interpolation_scheme=scheme)
    assert calls == [] and out[0].device.type == "meta"
