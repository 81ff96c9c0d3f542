"""Port vs JAX: gradients of the dense chief-ray march.

The port's side is ``march_chief_fused`` given CPU tensors, i.e.
``torch.autograd`` through the plain march (the plain version of the backward
kernels).  The JAX side is ``jax.grad`` through the Pallas fused march in
interpret mode: its stage backward kernel by default, its re-march backward
kernel with the stage-residual budget at 0.  Volumes, rays and losses are
those of tests/test_dense_fused.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import photon_tpu.ops.march_dense_fused as jax_mdf
from photon_tpu.ops.march_dense import march_chief_dense as jax_march_dense
from photon_tpu.ops.march_dense_fused import march_chief_fused as jax_fused
from photon_tpu.volume import build_density_volume
from photon_tpu_torch.ops.march_dense import march_chief_dense
from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
from tests.torch_port_helpers import port_volume


def _vol(n=8, lo=-6e4, hi=6e4, z0=4.0e5, z1=9.0e5):
    rng = np.random.default_rng(3)
    x = np.linspace(lo, hi, n)
    z = np.linspace(z0, z1, n)
    rho = 1.2 + 0.8 * rng.random((n, n, n))
    return build_density_volume(
        rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]], [lo, lo, z0])


def _chiefs(p=11, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-4e4, 4e4, p).astype(np.float32)
    ys = rng.uniform(-4e4, 4e4, p).astype(np.float32)
    zs = np.full(p, 1.0e6, np.float32)
    tx = rng.uniform(-0.08, 0.08, p)
    ty = rng.uniform(-0.08, 0.08, p)
    inv = 1.0 / np.sqrt(tx * tx + ty * ty + 1.0)
    return (xs, ys, zs, (tx * inv).astype(np.float32),
            (ty * inv).astype(np.float32), (-inv).astype(np.float32))


@pytest.fixture(scope="module")
def scene():
    jv = _vol()
    return jv, port_volume(jv), _chiefs()


def _normalised(got, ref):
    denom = np.abs(ref).max()
    assert denom > 0
    return got / denom, ref / denom


def _torch_field_grad(tv, rays, algorithm, substeps=None):
    field = tv.field.clone().requires_grad_(True)
    out = march_chief_fused(tv._replace(field=field),
                            *(torch.from_numpy(a) for a in rays),
                            algorithm=algorithm, substeps=substeps)
    loss = torch.sum(out[0] ** 2 + out[3] ** 2 * 1e6)
    loss.backward()
    return field.grad.numpy()


@pytest.mark.parametrize("backward", ["stage", "remarch"])
@pytest.mark.parametrize("algorithm", [1, 2])
def test_field_gradient_matches_jax(scene, algorithm, backward, monkeypatch):
    """Tolerance: 5e-4 of the largest gradient, the limit of the JAX
    package's own fused-vs-autodiff tests (tests/test_dense_fused.py:85-106
    and :186-211); seen here 2e-6 against the stage kernel and up to 3.4e-5
    against the re-march kernel (its reconstructed stage states)."""
    jv, tv, rays = scene
    if backward == "remarch":
        monkeypatch.setattr(jax_mdf, "_traj_max_bytes", lambda: 0)
    jrays = tuple(jnp.asarray(a) for a in rays)

    def loss(field):
        out = jax_fused(jv, *jrays, algorithm=algorithm, field=field,
                        interpret=True)
        return jnp.sum(out[0] ** 2 + out[3] ** 2 * 1e6)

    ref = np.asarray(jax.grad(loss)(jv.field))
    got = _torch_field_grad(tv, rays, algorithm)
    g, r = _normalised(got, ref)
    print(f"alg {algorithm} {backward}: max normalised error "
          f"{np.abs(g - r).max():.3g}")
    np.testing.assert_allclose(g, r, atol=5e-4)


def test_substep_field_gradient_matches_jax(scene):
    """RK4 with two substeps: autograd through the plain march on the CPU
    against jax.grad through the per-stage march (no Pallas), 5e-4 as
    tests/test_dense_fused.py:264-284."""
    jv, tv, rays = scene
    jrays = tuple(jnp.asarray(a) for a in rays)

    def loss(field):
        out = jax_march_dense(jv, *jrays, algorithm=3, field=field,
                              use_pallas_sampler=False)
        return jnp.sum(out[0] ** 2 + out[3] ** 2 * 1e6)

    ref = np.asarray(jax.grad(loss)(jv.field))
    got = _torch_field_grad(tv, rays, 3, substeps=2)
    g, r = _normalised(got, ref)
    np.testing.assert_allclose(g, r, atol=5e-4)


def test_entry_state_gradients_match_jax(scene):
    """Cotangents of the entry position and direction, 1e-3 of the largest
    (tests/test_dense_fused.py:109-132)."""
    jv, tv, (xs, ys, zs, dx, dy, dz) = scene

    def jax_run(args):
        x, t = args
        inv = 1.0 / jnp.sqrt(t * t + dy * dy + dz * dz)
        o = jax_fused(jv, x, jnp.asarray(ys), jnp.asarray(zs), t * inv,
                      dy * inv, dz * inv, algorithm=2, interpret=True)
        return jnp.sum(o[0]) + 1e6 * jnp.sum(o[3])

    ref = jax.grad(jax_run)((jnp.asarray(xs), jnp.asarray(dx)))

    x = torch.from_numpy(xs).requires_grad_(True)
    t = torch.from_numpy(dx).requires_grad_(True)
    tdy, tdz = torch.from_numpy(dy), torch.from_numpy(dz)
    inv = 1.0 / torch.sqrt(t * t + tdy * tdy + tdz * tdz)
    o = march_chief_fused(tv, x, torch.from_numpy(ys), torch.from_numpy(zs),
                          t * inv, tdy * inv, tdz * inv, algorithm=2)
    (torch.sum(o[0]) + 1e6 * torch.sum(o[3])).backward()
    for got, r in zip((x.grad, t.grad), ref):
        g, r = _normalised(got.numpy(), np.asarray(r))
        np.testing.assert_allclose(g, r, atol=1e-3)


def test_entry_z_gradient_matches_jax(scene):
    """Rays that start inside the volume's z range, so that the entry z is a
    differentiated input (tests/test_dense_fused.py:135-157), 1e-3."""
    jv, tv, (xs, ys, _, dx, dy, dz) = scene
    zs_in = np.linspace(5.0e5, 8.5e5, xs.shape[0]).astype(np.float32)

    def jax_run(z0):
        o = jax_fused(jv, jnp.asarray(xs), jnp.asarray(ys), z0,
                      jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz),
                      algorithm=2, interpret=True)
        return jnp.sum(o[0]) + 1e6 * jnp.sum(o[3])

    ref = np.asarray(jax.grad(jax_run)(jnp.asarray(zs_in)))
    z0 = torch.from_numpy(zs_in).requires_grad_(True)
    o = march_chief_fused(tv, torch.from_numpy(xs), torch.from_numpy(ys), z0,
                          *(torch.from_numpy(a) for a in (dx, dy, dz)),
                          algorithm=2)
    (torch.sum(o[0]) + 1e6 * torch.sum(o[3])).backward()
    g, r = _normalised(z0.grad.numpy(), ref)
    np.testing.assert_allclose(g, r, atol=1e-3)


@pytest.mark.parametrize("algorithm", [1, 2])
def test_upward_missing_and_horizontal_rays_give_finite_gradients(scene,
                                                                  algorithm):
    """A ray that never takes a slab's step must not reach the field's
    gradient through 0 * inf: upward rays, rays below the volume and a
    horizontal ray (Tz = 0) share the batch with rays that march."""
    _, tv, rays = scene
    rays = [a.copy() for a in rays]
    rays[5][::3] *= -1.0                    # upward
    rays[2][1] = 3.0e5                      # below the volume
    rays[3][4], rays[4][4], rays[5][4] = 1.0, 0.0, 0.0   # horizontal
    field = tv.field.clone().requires_grad_(True)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in rays]
    out = march_chief_fused(tv._replace(field=field), *ts,
                            algorithm=algorithm)
    sum((o ** 2).sum() for o in out).backward()
    assert torch.isfinite(field.grad).all() and field.grad.abs().max() > 0
    # (the horizontal ray's own entry advance divides by its dcz = 0, on
    # either package; every other ray's gradients are finite)
    others = torch.arange(len(rays[0])) != 4
    for t in ts:
        assert torch.isfinite(t.grad[others]).all()
    # and the gate leaves the values where they were: rays that march agree
    # with the ungated arithmetic of a batch of their own
    keep = np.ones(len(rays[0]), bool)
    keep[::3] = keep[1] = keep[4] = False
    alone = march_chief_dense(tv, *(torch.from_numpy(a[keep]) for a in rays),
                              algorithm=algorithm)
    for o, a in zip(out, alone):
        assert torch.equal(o.detach()[torch.from_numpy(keep)], a)
