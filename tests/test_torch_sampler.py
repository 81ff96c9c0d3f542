"""Port vs JAX: the per-stage slab sampler (``dense_slab_sample``).

The port's side is the plain PyTorch sampler (what a CPU tensor gets, and the
plain version of the sampler kernels) and ``torch.autograd`` through it.  The
JAX side is the Pallas sampler in interpret mode with its own backward kernel,
as tests/test_dense_pallas.py runs it.  Shapes, coordinates and tolerances are
those of that file: values rtol 2e-5 / atol 2e-6, gradients rtol 2e-4 / atol
2e-5 of each gradient's maximum.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.ops.march_dense_pallas import (
    dense_slab_sample as jax_slab_sample)
from photon_tpu_torch import kernels
from photon_tpu_torch.ops import march_dense_sampler as mds
from photon_tpu_torch.ops.march_dense_sampler import (dense_slab_sample,
                                                      slab_sample_backward,
                                                      slab_sample_forward,
                                                      slab_sample_plain)

W, H = 16, 12


def _jax_sample(lo, hi, ux, uy, uz, scheme):
    """(H, W, 4) slabs into the Pallas sampler's transposed layout."""
    loT = jnp.transpose(lo, (1, 2, 0)).reshape(W * 4, H)
    hiT = jnp.transpose(hi, (1, 2, 0)).reshape(W * 4, H)
    return jax_slab_sample((W, H, scheme, True), loT, hiT, ux, uy, uz)


def _slabs(rng):
    return (rng.normal(size=(H, W, 4)).astype(np.float32),
            rng.normal(size=(H, W, 4)).astype(np.float32))


@pytest.mark.parametrize("scheme", [1, 2])
def test_plain_sampler_matches_pallas_sampler(scheme):
    """Coordinates inside, on the border and beyond both clamps."""
    P = 37
    rng = np.random.default_rng(scheme)
    lo, hi = _slabs(rng)
    ux = rng.uniform(-4, W + 3, P).astype(np.float32)
    uy = rng.uniform(-4, H + 3, P).astype(np.float32)
    uz = rng.uniform(0, 1, P).astype(np.float32)
    # exactly on the clamps and on voxel centres
    ux[:6] = [-2.0, W + 1.0, 0.0, W - 1.0, 3.0, -5.0]
    uy[:6] = [H + 1.0, -2.0, H - 1.0, 0.0, 7.0, H + 4.0]
    ref = _jax_sample(*(jnp.asarray(a) for a in (lo, hi, ux, uy, uz)), scheme)
    got = dense_slab_sample(*(torch.from_numpy(a)
                              for a in (lo, hi, ux, uy, uz)), scheme)
    worst = 0.0
    for r, g in zip(ref, got):
        worst = max(worst, float(np.abs(g.numpy() - np.asarray(r)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-6)
    print(f"scheme {scheme}: max abs err {worst:.3g}")


@pytest.fixture(scope="module")
def gradients():
    """Both sides' five gradients (d_lo, d_hi, d_ux, d_uy, d_uz) of one
    weighted sum of the samples, by scheme; coordinates kept off the weight
    kernels' kinks, and reaching past both clamps."""
    out = {}
    for scheme in (1, 2):
        P = 29
        rng = np.random.default_rng(10 + scheme)
        lo, hi = _slabs(rng)
        ux = (rng.integers(-3, W + 2, P) + 0.3).astype(np.float32)
        uy = (rng.integers(-3, H + 2, P) + 0.6).astype(np.float32)
        uz = rng.uniform(0.05, 0.95, P).astype(np.float32)
        ramp = np.arange(1.0, P + 1, dtype=np.float32)

        def loss_jax(lo, hi, ux, uy, uz):
            s = _jax_sample(lo, hi, ux, uy, uz, scheme)
            return sum((v * jnp.asarray(ramp)).sum() for v in s)

        ref = jax.grad(loss_jax, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (lo, hi, ux, uy, uz)))
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in (lo, hi, ux, uy, uz)]
        s = dense_slab_sample(*ts, scheme)
        sum((v * torch.from_numpy(ramp)).sum() for v in s).backward()
        out[scheme] = ([np.asarray(r) for r in ref],
                       [t.grad.numpy() for t in ts],
                       dict(ux=ux, uy=uy))
    return out


@pytest.mark.parametrize("which", ["d_lo", "d_hi", "d_ux", "d_uy", "d_uz"])
@pytest.mark.parametrize("scheme", [1, 2])
def test_plain_sampler_gradient_matches_pallas_backward(gradients, scheme,
                                                        which):
    ref, got, coords = gradients[scheme]
    i = ["d_lo", "d_hi", "d_ux", "d_uy", "d_uz"].index(which)
    scale = max(float(np.abs(ref[i]).max()), 1e-6)
    print(f"scheme {scheme} {which}: max err "
          f"{np.abs(got[i] - ref[i]).max() / scale:.3g} of the maximum")
    np.testing.assert_allclose(got[i], ref[i], rtol=2e-4, atol=2e-5 * scale)
    if which in ("d_ux", "d_uy"):
        # a coordinate held by the clamp gets exactly zero, others do not
        u = coords[which[2:]]
        n = W if which == "d_ux" else H
        lo_c, hi_c = (-2.0, n + 1.0) if scheme == 2 else (0.0, n - 1.0)
        held = (u < lo_c) | (u > hi_c)
        assert held.any() and (got[i][held] == 0).all()
        assert (got[i][~held] != 0).any()


def test_cubic_weights_fold_onto_the_border():
    """Far outside the grid every tap clips onto one border voxel and the
    weights sum to one: the sample is the border value."""
    rng = np.random.default_rng(5)
    lo, hi = (torch.from_numpy(a) for a in _slabs(rng))
    ux = torch.tensor([-9.0, W + 7.0, -2.0, W + 1.0])
    uy = torch.tensor([-9.0, H + 7.0, H + 1.0, -2.0])
    uz = torch.zeros(4)
    got = torch.stack(slab_sample_plain(lo, hi, ux, uy, uz, 2), -1)
    want = torch.stack([lo[0, 0], lo[H - 1, W - 1], lo[H - 1, 0],
                        lo[0, W - 1]])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def _bad_sampler_calls():
    lo = torch.zeros(H, W, 4)
    u = torch.zeros(5)
    return {
        "forward: slab without channels": lambda: slab_sample_forward(
            torch.zeros(H, W), torch.zeros(H, W), u, u, u, 1),
        "forward: slabs of two shapes": lambda: slab_sample_forward(
            lo, torch.zeros(H, W + 1, 4), u, u, u, 1),
        "forward: float64 coordinates": lambda: slab_sample_forward(
            lo, lo, u.double(), u, u, 1),
        "forward: coordinates of two lengths": lambda: slab_sample_forward(
            lo, lo, u, u[:4], u, 2),
        "forward: strided coordinates": lambda: slab_sample_forward(
            lo, lo, torch.zeros(10)[::2], u, u, 1),
        "forward: unknown scheme": lambda: slab_sample_forward(
            lo, lo, u, u, u, 3),
        "backward: cotangent of another batch": lambda: slab_sample_backward(
            lo, lo, u, u, u, torch.zeros(4, 6), 1),
        "backward: cotangent not (4, P)": lambda: slab_sample_backward(
            lo, lo, u, u, u, torch.zeros(5, 4), 2),
        "backward: strided slab": lambda: slab_sample_backward(
            torch.zeros(H, W, 8)[..., ::2], lo, u, u, u, torch.zeros(4, 5), 1),
    }


@pytest.mark.parametrize("case", sorted(_bad_sampler_calls()))
def test_sampler_wrappers_check_their_tensors_before_any_build(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_sampler_calls()[case]()
    assert kernels._libs == {}


def test_a_tensor_off_the_cpu_takes_the_kernel_wrapper(monkeypatch):
    """Meta tensors stand in for the card: ``dense_slab_sample`` hands them
    to the kernel wrapper (which would build and launch), never to the plain
    version; CPU tensors never reach the wrapper."""
    calls = []

    def fake_forward(lo, hi, ux, uy, uz, scheme):
        calls.append((lo.device.type, scheme))
        return torch.empty((4, ux.shape[0]), device=lo.device)

    monkeypatch.setattr(mds, "slab_sample_forward", fake_forward)
    lo = torch.empty(H, W, 4, device="meta")
    u = torch.empty(7, device="meta")
    out = dense_slab_sample(lo, lo, u, u, u, 2)
    assert calls == [("meta", 2)] and len(out) == 4
    assert out[0].shape == (7,)
    dense_slab_sample(torch.zeros(H, W, 4), torch.zeros(H, W, 4),
                      torch.zeros(7), torch.zeros(7), torch.zeros(7), 1)
    assert len(calls) == 1
    assert slab_sample_forward.launches == 0
    assert slab_sample_backward.launches == 0


def test_without_a_compiler_the_kernel_route_raises(monkeypatch):
    """No fallback: a tensor that is not on the CPU builds the kernel or
    raises; it never gets the plain version."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    lo = torch.empty(H, W, 4, device="meta")
    u = torch.empty(7, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        dense_slab_sample(lo, lo, u, u, u, 1)
