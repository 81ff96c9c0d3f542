"""Port vs JAX: the transpose of the particle splat.

The port's side is ``splat_particles`` / ``particle_splat`` given CPU
tensors, i.e. ``torch.autograd`` through the plain patch + scatter version
(the plain version of the transpose kernel); the JAX side is ``jax.vjp`` of
``_particle_splat_xla``, which is also what the JAX package's fused splat
uses as its backward.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.ops.sensor_fast import _particle_splat_xla
from photon_tpu.ops.sensor_fast import particle_splat as jax_particle_splat
from photon_tpu_torch.ops.sensor_fast import particle_splat
from photon_tpu_torch.ops.splat import splat_particles
from tests.test_torch_splat import _anchors, _spots


def _close(got, ref, what):
    """1e-5 of each cotangent's largest value: both sides evaluate the same
    erf and Gaussians in f32 and differ in erf's and exp's last bits and in
    the order of the sum over the patch (seen ~1e-6)."""
    for name, g, r in zip(("d_Xs", "d_Ys", "d_A"), got, ref):
        g, r = np.asarray(g), np.asarray(r)
        denom = np.abs(r).max()
        assert denom > 0, name
        np.testing.assert_allclose(g / denom, r / denom, rtol=0, atol=1e-5,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("K,diameter", [(8, 3.0), (12, 5.0)])
def test_splat_transpose_matches_jax(K, diameter):
    nx, ny = 96, 64
    X, Y, A = _spots(p=60, nx=nx, ny=ny)
    X = np.where(A > 0, X, -1e6).astype(np.float32)
    A = (A * np.float32(np.pi / 32.0)).astype(np.float32)
    pc, pr = _anchors(X, Y, A)
    col0 = np.clip(pc - K // 2, 0, nx - K).astype(np.int32)
    row0 = np.clip(pr - K // 2, 0, ny - K).astype(np.int32)
    ct = np.random.default_rng(2).normal(size=(ny, nx)).astype(np.float32)

    static = (nx, ny, float(diameter), K, 0.75)
    _, vjp = jax.vjp(
        lambda x, y, a: _particle_splat_xla(x, y, a, jnp.asarray(col0),
                                            jnp.asarray(row0), static),
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(A))
    ref = vjp(jnp.asarray(ct))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (X, Y, A)]
    img = splat_particles(*leaves, torch.from_numpy(col0),
                          torch.from_numpy(row0), K=K, ny=ny, nx=nx,
                          diameter=diameter, render_fraction=0.75)
    got = torch.autograd.grad(img, leaves, grad_outputs=torch.from_numpy(ct))
    _close([g.numpy() for g in got], ref, f"K={K}")
    # particles without a deposit (zero amplitude, far sentinel) move nothing
    assert (got[0].numpy()[4:10] == 0).all()


def test_particle_splat_gradients_match_jax():
    """Through the sentinels, the pi/32 scale and the anchor clamp that stay
    plain tensor code around the kernels on either side."""
    nx, ny, K, D = 96, 64, 8, 3.0
    X, Y, A = _spots(p=60, nx=nx, ny=ny, seed=3)
    pc, pr = _anchors(X, Y, A)
    ct = np.random.default_rng(4).normal(size=(ny, nx)).astype(np.float32)
    kw = dict(nx=nx, ny=ny, diameter=D, patch=K)

    _, vjp = jax.vjp(
        lambda x, y, a: jax_particle_splat(x, y, a, jnp.asarray(pc),
                                           jnp.asarray(pr), use_pallas=False,
                                           **kw),
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(A))
    ref = vjp(jnp.asarray(ct))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (X, Y, A)]
    img = particle_splat(*leaves, torch.from_numpy(pc), torch.from_numpy(pr),
                         **kw)
    got = torch.autograd.grad(img, leaves, grad_outputs=torch.from_numpy(ct))
    assert all(torch.isfinite(g).all() for g in got)
    _close([g.numpy() for g in got], ref, "particle_splat")
