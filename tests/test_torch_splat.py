"""Port vs JAX: the per-particle erf splat (plain PyTorch version on the CPU
against the XLA patch + scatter path and the Pallas kernels in interpret
mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.ops.sensor_fast import particle_splat as jax_particle_splat
from photon_tpu.ops.splat_pallas import (splat_particles_pallas,
                                         splat_particles_pallas_v2)
from photon_tpu_torch.ops.sensor_fast import particle_splat
from photon_tpu_torch.ops.splat import splat_particles


def _spots(p=300, nx=256, ny=192, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-0.5, nx - 0.5, p).astype(np.float32)
    Y = rng.uniform(-0.5, ny - 0.5, p).astype(np.float32)
    A = rng.uniform(0.1, 2.0, p).astype(np.float32)
    # spots on the frame's edge and corners
    X[:4] = [-0.4, nx - 0.6, 3.0, nx / 2.0]
    Y[:4] = [-0.4, ny - 0.6, ny - 1.0, 0.2]
    # particles without a surviving ray: zero amplitude, sentinel anchor
    A[4:10] = 0.0
    X[4:7] = -1e6
    return X, Y, A


def _anchors(X, Y, A):
    ok = A > 0
    pc = np.round(np.where(ok, X, -1e6)).astype(np.int32)
    pr = np.round(np.where(ok, Y, -1e6)).astype(np.int32)
    return pc, pr


# tolerance of the JAX package's own splat tests (tests/test_splat_pallas.py):
# atol = 3e-6 of the image maximum — the Pallas kernels use the A&S 7.1.26 erf
# (|err| < 1.5e-7); against the XLA path only erf's last bits differ
_ATOL = 3e-6


@pytest.mark.parametrize("K,diameter", [(8, 3.0), (12, 5.0)])
def test_particle_splat_matches_xla(K, diameter):
    nx, ny = 256, 192
    X, Y, A = _spots(nx=nx, ny=ny)
    pc, pr = _anchors(X, Y, A)
    kw = dict(nx=nx, ny=ny, diameter=diameter, patch=K)
    ref = np.asarray(jax_particle_splat(
        *(jnp.asarray(a) for a in (X, Y, A, pc, pr)), use_pallas=False, **kw))
    got = particle_splat(*(torch.from_numpy(a) for a in (X, Y, A, pc, pr)),
                         **kw).numpy()
    assert ref.sum() > 0 and got.shape == (ny, nx)
    np.testing.assert_allclose(got, ref, atol=_ATOL * ref.max(), rtol=0)


@pytest.mark.parametrize("K,kernel", [(8, "v2"), (12, "v1")])
def test_splat_matches_pallas_interpret(K, kernel):
    nx, ny, D = 256, 192, 3.0
    X, Y, A = _spots(nx=nx, ny=ny, seed=1)
    X = np.where(A > 0, X, -1e6).astype(np.float32)
    A = (A * np.float32(np.pi / 32.0)).astype(np.float32)
    pc, pr = _anchors(X, Y, A)
    col0 = np.clip(pc - K // 2, 0, nx - K).astype(np.int32)
    row0 = np.clip(pr - K // 2, 0, ny - K).astype(np.int32)
    fn = splat_particles_pallas_v2 if kernel == "v2" else splat_particles_pallas
    ref = np.asarray(fn(*(jnp.asarray(a) for a in (X, Y, A, col0, row0)),
                        K=K, ny=ny, nx=nx, diameter=D, render_fraction=0.75,
                        interpret=True))
    got = splat_particles(
        *(torch.from_numpy(a) for a in (X, Y, A, col0, row0)),
        K=K, ny=ny, nx=nx, diameter=D, render_fraction=0.75).numpy()
    assert ref.sum() > 0
    np.testing.assert_allclose(got, ref, atol=_ATOL * ref.max(), rtol=0)


def test_zero_amplitude_particles_deposit_nothing():
    nx = ny = 64
    X = np.array([10.0, 30.0, -1e6], np.float32)
    Y = np.array([10.0, 30.0, -1e6], np.float32)
    A = np.array([0.0, 1.0, 0.0], np.float32)
    pc, pr = _anchors(X, Y, A)
    img = particle_splat(*(torch.from_numpy(a) for a in (X, Y, A, pc, pr)),
                         nx=nx, ny=ny, diameter=3.0, patch=8).numpy()
    assert img[5:15, 5:15].sum() == 0.0 and img[:8, :8].sum() == 0.0
    assert img[26:35, 26:35].sum() > 0


def test_patch_too_small_for_mask_raises():
    z = torch.zeros(2)
    zi = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="circular render mask"):
        particle_splat(z, z, z, zi, zi, nx=64, ny=64, diameter=6.0, patch=6)
