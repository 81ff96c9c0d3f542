"""Port vs JAX: volume_from_rho, the renderer's field gradient and invert_bos
(the port on the CPU, i.e. torch.autograd through the plain versions)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.inverse import invert_bos as jax_invert_bos
from photon_tpu.inverse import volume_from_rho as jax_volume_from_rho
from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.render_fast import render_image_fast as jax_render
from photon_tpu.models.scenes import bos_source as jax_bos_source
from photon_tpu.utils.rng import lens_samples as jax_lens_samples
from photon_tpu.volume import build_density_volume as jax_build_volume
from photon_tpu_torch.inverse import (InversionResult, invert_bos,
                                      volume_from_rho)
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.volume import build_density_volume
from tests.test_bos_pipeline import bos_case
from tests.torch_port_helpers import port_config, port_source, port_volume


def _small_volume(setup, n=10, grad_rho=4.0, rho0=1.225):
    """The volume of tests/test_inverse.py: a density ramp along x between
    the dot plane and the lens."""
    extent = 4e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z = np.linspace(setup.object_distance - 0.6 * setup.object_distance,
                    setup.object_distance - 0.1 * setup.object_distance, n)
    X = x[:, None, None] * np.ones((1, n, n))
    rho = rho0 + grad_rho * (X - x.min()) / (x.max() - x.min())
    geometry = ([x[1] - x[0], x[1] - x[0], z[1] - z[0]], [x[0], x[0], z[0]])
    return jax_build_volume(rho, *geometry), rho.astype(np.float32), geometry


def _scene(lens_model, n_dots=8, rays=16, n=10):
    cfg = bos_case(lens_model, n_dots=n_dots, rays=rays)
    setup = jax_camera_setup(cfg)
    src, *_ = jax_bos_source(cfg, setup, np.random.default_rng(4))
    r1, r2 = (np.asarray(r) for r in
              jax_lens_samples(jax.random.key(9), rays))
    jvol, rho, geometry = _small_volume(setup, n=n)
    tcfg = port_config(cfg)
    return dict(jax=(cfg, setup, src, r1, r2), jax_vol=jvol, rho=rho,
                geometry=geometry,
                torch=(tcfg, camera_setup(tcfg), port_source(src), r1, r2),
                torch_vol=port_volume(jvol))


@pytest.fixture(scope="module")
def apparent():
    return _scene("apparent")


def test_volume_from_rho_matches_build_density_volume(apparent):
    """rtol 1e-4 as tests/test_inverse.py:29-35 (f32 stencils against the
    float64 numpy precompute), against the port's own precompute and the JAX
    package's volume_from_rho."""
    rho, tv = apparent["rho"], apparent["torch_vol"]
    rebuilt = volume_from_rho(torch.from_numpy(rho), tv)
    built = build_density_volume(rho, *apparent["geometry"], device="cpu")
    np.testing.assert_allclose(rebuilt.field.numpy(), built.field.numpy(),
                               rtol=1e-4, atol=1e-12)
    ref = jax_volume_from_rho(jnp.asarray(rho), apparent["jax_vol"])
    np.testing.assert_allclose(rebuilt.field.numpy(), np.asarray(ref.field),
                               rtol=1e-5, atol=1e-12)
    # only the field is replaced: geometry and data_min are the template's
    assert rebuilt.data_min == tv.data_min
    assert rebuilt.min_bound is tv.min_bound
    assert rebuilt.field.shape == tv.field.shape


def test_volume_from_rho_gradient_matches_jax(apparent):
    """The stencils' transpose: a linear map, so the two agree to f32
    rounding of sums of three terms (1e-6 of the largest)."""
    rho = apparent["rho"]
    w = np.random.default_rng(0).normal(
        size=apparent["torch_vol"].field.shape).astype(np.float32)
    ref = np.asarray(jax.grad(lambda r: jnp.sum(jax_volume_from_rho(
        r, apparent["jax_vol"]).field * jnp.asarray(w)))(jnp.asarray(rho)))
    r = torch.from_numpy(rho).requires_grad_(True)
    (volume_from_rho(r, apparent["torch_vol"]).field
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_render_field_gradient_matches_jax():
    """d mean(img^2) / d field through march, fan and splat, thick lens:
    cosine >= 0.9999, the JAX package's own bar for its fused fan against
    its array chain (tests/test_fan_pallas.py:67-78)."""
    sc = _scene("general")
    jv, tv = sc["jax_vol"], sc["torch_vol"]
    ref = np.asarray(jax.grad(lambda f: jnp.mean(jax_render(
        *sc["jax"], vol=jv._replace(field=f)) ** 2))(jv.field))
    field = tv.field.clone().requires_grad_(True)
    img = render_image_fast(*sc["torch"], vol=tv._replace(field=field),
                            device="cpu")
    torch.mean(img ** 2).backward()
    got = field.grad.numpy()
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    cos = _cosine(got, ref)
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"render field gradient: cosine {cos:.7f}, relative L2 {rel:.3g}")
    assert cos >= 0.9999, cos


def test_chunked_render_gradient_equals_unchunked(apparent):
    """The chunk loop accumulates the image in place and stays
    differentiable: same gradient up to the f32 order of the sum."""
    tv = apparent["torch_vol"]
    grads = []
    for ppc in (None, 7):
        field = tv.field.clone().requires_grad_(True)
        img = render_image_fast(*apparent["torch"],
                                vol=tv._replace(field=field),
                                particles_per_chunk=ppc, device="cpu")
        assert img.requires_grad
        torch.mean(img ** 2).backward()
        grads.append(field.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0,
                               atol=1e-5 * np.abs(grads[0]).max())


def test_invert_bos_matches_jax(apparent):
    """The scene and settings of tests/test_inverse.py:38-62 on both sides:
    the same observation, 30 Adam steps from a uniform start."""
    jcfg, jsetup, jsrc, r1, r2 = apparent["jax"]
    jv, tv = apparent["jax_vol"], apparent["torch_vol"]
    observed = np.array(jax_render(*apparent["jax"], vol=jv))
    kw = dict(steps=30, learning_rate=0.05)
    ref = jax_invert_bos(jcfg, jsetup, jsrc, r1, r2, observed, jv, **kw)
    seen = []
    got = invert_bos(*apparent["torch"], observed, tv, device="cpu",
                     callback=lambda t, loss, rho: seen.append((t, loss)),
                     **kw)
    assert isinstance(got, InversionResult) and len(got.losses) == 30
    assert seen[0] == (1, got.losses[0]) and seen[-1][0] == 30
    assert got.rho.shape == apparent["rho"].shape

    # first loss: the same render of the same uniform field against the same
    # image (seen equal to six digits; the renderers agree to ~1e-5 in L1)
    np.testing.assert_allclose(got.losses[0], ref.losses[0], rtol=1e-4)
    # first gradient, d loss / d rho at the uniform start: cosine >= 0.9999
    # and 1e-4 of the largest component (seen 8.7e-6)
    gd = jcfg.density_gradients.gladstone_dale
    rho0 = np.full_like(apparent["rho"], jcfg.density_gradients.rho_0)
    g_ref = np.asarray(jax.grad(lambda r: jnp.mean((jax_render(
        *apparent["jax"], vol=jax_volume_from_rho(r, jv, gd))
        - jnp.asarray(observed)) ** 2))(jnp.asarray(rho0)))
    r0 = torch.from_numpy(rho0).requires_grad_(True)
    img = render_image_fast(*apparent["torch"],
                            vol=volume_from_rho(r0, tv, gd), device="cpu")
    torch.mean((img - torch.from_numpy(observed)) ** 2).backward()
    g_got = r0.grad.numpy()
    g_err = float(np.abs(g_got - g_ref).max() / np.abs(g_ref).max())
    print(f"first gradient: cosine {_cosine(g_got, g_ref):.7f}, max error "
          f"{g_err:.3g} of the largest component")
    assert _cosine(g_got, g_ref) >= 0.9999 and g_err < 1e-4

    # loss history: within 1e-4 of the first loss of the JAX history at every
    # step (seen 5.5e-6: sign flips of voxels with a negligible gradient
    # perturb the Adam path a little)
    band = 1e-4 * ref.losses[0]
    worst = max(abs(a - b) for a, b in zip(got.losses, ref.losses))
    print(f"losses: first {got.losses[0]:.6g} / {ref.losses[0]:.6g}, last "
          f"{got.losses[-1]:.6g} / {ref.losses[-1]:.6g}, worst gap "
          f"{worst:.3g} (band {band:.3g})")
    assert worst < band
    assert got.losses[-1] < 0.2 * got.losses[0], got.losses[::10]

    # the re-render criterion of tests/test_inverse.py:57-62
    img_rec = render_image_fast(*apparent["torch"], vol=got.volume,
                                device="cpu").numpy()
    img_uniform = render_image_fast(*apparent["torch"], device="cpu").numpy()
    err_rec = np.abs(img_rec - observed).sum()
    err_uniform = np.abs(img_uniform - observed).sum()
    assert err_rec < 0.5 * err_uniform, (err_rec, err_uniform)
    # the recovered volume is built like any other: frame shift included
    np.testing.assert_allclose(got.volume.min_bound, tv.min_bound, rtol=1e-6)


def test_invert_bos_smoothness_term_and_device_rule(apparent):
    observed = np.zeros((256, 256), np.float32)
    tv = apparent["torch_vol"]
    rng = np.random.default_rng(1)
    rho0 = (1.225 + 0.1 * rng.random(apparent["rho"].shape)).astype(np.float32)
    plain = invert_bos(*apparent["torch"], observed, tv, rho0=rho0, steps=1,
                       device="cpu")
    smooth = invert_bos(*apparent["torch"], observed, tv, rho0=rho0, steps=1,
                        smoothness=1e3, device="cpu")
    assert smooth.losses[0] > plain.losses[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            invert_bos(*apparent["torch"], observed, tv, steps=1)
