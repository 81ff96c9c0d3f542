"""Port vs JAX: the dense chief-ray march (plain PyTorch version on the CPU
against photon_tpu.ops.march_dense at f32 HIGHEST precision)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.models.optics import camera_setup
from photon_tpu.ops.march_dense import (chief_deltas_dense as jax_deltas,
                                        march_chief_dense as jax_march)
from photon_tpu.ops.march_dense_fused import march_chief_fused as jax_fused
from photon_tpu.volume import build_density_volume
from photon_tpu_torch.ops.march_dense import (chief_deltas_dense,
                                              march_chief_dense)
from photon_tpu_torch.ops import march_dense as md
from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
from tests.test_bos_pipeline import bos_case, gradient_volume_between
from tests.torch_port_helpers import port_volume


def _random_volume():
    """Random field with W != H != D, so an axis swap cannot hide."""
    rng = np.random.default_rng(3)
    w, h, d = 10, 14, 12
    x = np.linspace(-6e4, 6e4, w)
    y = np.linspace(-5e4, 7e4, h)
    z = np.linspace(4.0e5, 9.0e5, d)
    rho = 1.2 + 0.8 * rng.random((w, h, d))
    return build_density_volume(
        rho, [x[1] - x[0], y[1] - y[0], z[1] - z[0]], [x[0], y[0], z[0]])


@pytest.fixture(scope="module")
def volumes():
    setup = camera_setup(bos_case("general"))
    grad, _, _ = gradient_volume_between(setup)          # 32^3
    out = {}
    for name, v in (("gradient32", grad), ("random10x14x12", _random_volume())):
        out[name] = (v, port_volume(v))
    return out


def _chiefs(vol, p=48, seed=0):
    """Rays above, inside and below the volume, some travelling upward."""
    rng = np.random.default_rng(seed)
    mn, mx = np.asarray(vol.min_bound), np.asarray(vol.max_bound)
    xs = rng.uniform(0.8 * mn[0], 0.8 * mx[0], p)
    ys = rng.uniform(0.8 * mn[1], 0.8 * mx[1], p)
    depth = mx[2] - mn[2]
    zs = np.full(p, mx[2] + 0.2 * depth)                     # above
    zs[p // 2: 3 * p // 4] = rng.uniform(mn[2], mx[2], p // 4)   # inside
    zs[3 * p // 4:] = mn[2] - 0.05 * depth                  # below
    tx = rng.uniform(-0.08, 0.08, p)
    ty = rng.uniform(-0.08, 0.08, p)
    inv = 1.0 / np.sqrt(tx * tx + ty * ty + 1.0)
    dz = -inv
    dz[::7] *= -1.0                                          # upward rays
    return tuple(a.astype(np.float32) for a in
                 (xs, ys, zs, tx * inv, ty * inv, dz))


def _close(got, ref, what, scale):
    """Ceiling of the JAX package's own fused-vs-XLA test
    (tests/test_dense_fused.py): rtol = 2e-4.  The absolute term is scaled
    to the coordinates instead of that test's fixed 2e-4: positions are
    formed from ``p - min_bound`` at |p| up to ``scale`` um, so a ray that
    lands near x = 0 still carries f32 rounding of 4 eps * scale
    (0.03 .. 0.4 um here).  Both sides are f32 with the same formulas; what
    is seen is a few 1e-3 um in position and ~1e-7 in direction (summation
    order of the eight-voxel blend, XLA's fusion choices)."""
    pos_atol = 4.0 * np.finfo(np.float32).eps * scale
    worst = {}
    for name, g, r in zip(("x", "y", "z", "dx", "dy", "dz"), got, ref):
        g, r = np.asarray(g), np.asarray(r)
        worst[name] = float(np.abs(g - r).max())
        np.testing.assert_allclose(
            g, r, rtol=2e-4, atol=pos_atol if name in "xyz" else 2e-6,
            err_msg=f"{what}: {name}")
    # directions are O(1): hold them far tighter than the ceiling
    assert max(worst["dx"], worst["dy"], worst["dz"]) < 2e-6, worst
    print(f"{what}: max abs err {worst} (pos atol {pos_atol:.3g})")


def _scale(vol):
    return float(max(np.abs(np.asarray(vol.min_bound)).max(),
                     np.abs(np.asarray(vol.max_bound)).max()))


@pytest.mark.parametrize("algorithm,substeps", [(1, None), (2, None), (3, 2)])
@pytest.mark.parametrize("volume", ["gradient32", "random10x14x12"])
def test_march_matches_jax(volumes, volume, algorithm, substeps):
    jv, tv = volumes[volume]
    rays = _chiefs(jv)
    ref = jax_march(jv, *(jnp.asarray(a) for a in rays), algorithm=algorithm,
                    substeps=substeps, use_pallas_sampler=False)
    got = march_chief_dense(tv, *(torch.from_numpy(a) for a in rays),
                            algorithm=algorithm, substeps=substeps)
    _close([g.numpy() for g in got], ref, f"{volume} alg {algorithm}",
           _scale(jv))
    # rays that never enter keep their direction bit for bit
    up = rays[5] > 0
    assert up.any()
    np.testing.assert_array_equal(got[3].numpy()[up], rays[3][up])
    np.testing.assert_array_equal(got[0].numpy()[up], rays[0][up])


def test_march_deflects(volumes):
    """The comparison above is not vacuous: the volume bends the rays."""
    jv, tv = volumes["gradient32"]
    rays = _chiefs(jv)
    got = march_chief_dense(tv, *(torch.from_numpy(a) for a in rays))
    entered = (rays[5] < 0) & (rays[2] >= float(jv.min_bound[2]))
    bend = np.abs(got[3].numpy() - rays[3])[entered]
    assert bend.max() > 1e-5


def test_deltas_match_jax(volumes):
    """Deltas subtract nearly equal positions of ~1e5 um: the tolerance is
    absolute and scaled to the position (f32 eps * 1e6 um ~ 0.1 um)."""
    jv, tv = volumes["random10x14x12"]
    rays = _chiefs(jv, seed=4)
    ref = jax_deltas(jv, *(jnp.asarray(a) for a in rays),
                     use_pallas_sampler=False)
    got = chief_deltas_dense(tv, *(torch.from_numpy(a) for a in rays))
    pos_atol = 4.0 * np.finfo(np.float32).eps * _scale(jv)
    for i, (g, r) in enumerate(zip(got, ref)):
        atol = pos_atol if i < 3 else 2e-6
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=atol)


def test_wrapper_on_cpu_matches_fused_interpret(volumes):
    """The kernel's wrapper given CPU tensors (its plain version) against
    the Pallas fused march in interpret mode with the 3-pass contraction."""
    jv, tv = volumes["random10x14x12"]
    rays = _chiefs(jv, p=24, seed=2)
    ref = jax_fused(jv, *(jnp.asarray(a) for a in rays), algorithm=2,
                    interpret=True, passes=3)
    got = march_chief_fused(tv, *(torch.from_numpy(a) for a in rays),
                            algorithm=2)
    _close([g.numpy() for g in got], ref, "fused interpret", _scale(jv))


def test_dense_support_and_unported_options(volumes):
    _, tv = volumes["random10x14x12"]
    # no slab cap: the one march takes every size
    assert not hasattr(md, "dense_march_supported")
    assert not hasattr(md, "DENSE_MAX_SLAB")
    rays = [torch.from_numpy(a) for a in _chiefs(tv, p=4)]
    with pytest.raises(ValueError, match="unknown interpolation_scheme"):
        march_chief_fused(tv, *rays, interpolation_scheme=3)
    with pytest.raises(ValueError, match="unknown ray_tracing_algorithm"):
        march_chief_dense(tv, *rays, algorithm=5)
