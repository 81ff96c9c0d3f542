"""Port vs JAX: volumes whose slab exceeds 256 x 256 voxels.

The JAX package marches such volumes with its windowed kernels
(``photon_tpu.ops.march_window``: per-block slab windows planned on the host);
the port marches every size with one gather march.  These tests hold the
port's march on the CPU (``march_chief_fused`` given CPU tensors, i.e. the
plain version, and ``torch.autograd`` through it) against

* the windowed kernels themselves, forward and backward, in interpret mode
  with the 3-pass contraction and a plan made with ``require_profit=False``
  (as tests/test_march_window.py runs them), and
* the JAX package's dense march with the XLA sampler and its slab cap lifted
  (the oracle of that file's gradient test beyond the cap), which also covers
  Adams-Bashforth and the substep gradients that the windowed kernels lack,

then ``choose_substeps`` on such a volume and the limits of the kernels'
wrappers.  Volumes and rays are those of tests/test_march_window.py.  The
renderer, the pipeline and ``invert_bos`` on such volumes are held in
tests/test_torch_render.py, tests/test_torch_pipeline.py and
tests/test_torch_inverse.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import photon_tpu.ops.march_dense as jmd
import photon_tpu.ops.march_window as jmw
from photon_tpu.ops.march_window import march_chief_windowed, plan_windows
from photon_tpu.volume import build_density_volume
from photon_tpu_torch.ops import march_dense_fused as mdf
from photon_tpu_torch.ops import march_dense_sampler as mds
from photon_tpu_torch.ops.march_dense import choose_substeps
from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
from tests.test_march_window import _chiefs as window_chiefs
from tests.test_march_window import _vol as window_vol
from tests.test_torch_march import _close, _scale
from tests.torch_port_helpers import port_volume


def _random_volume(w, h, d, seed, half_x):
    """A random physical refractivity (0.08 kg/m^3 of noise: micro-radian
    deflections, as the window plans assume) on a (w, h, d) grid of square
    voxels centred on the axis."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-half_x, half_x, w)
    vox = x[1] - x[0]
    rho = 1.225 + 0.08 * rng.random((w, h, d))
    vol = build_density_volume(
        rho, [vox, vox, (9.0e5 - 4.0e5) / (d - 1)],
        [-half_x, -half_x * h / w, 4.0e5])
    return vol, vox, rng


def _downward(rng, p, half_x, half_y, slope_y, outside=0):
    """Random downward chief rays from above the volume; the first
    ``outside`` start beyond its +x face and sample the clamped border."""
    xs = rng.uniform(-half_x, half_x, p)
    xs[:outside] = rng.uniform(1.05, 1.25, outside) * half_x / 0.95
    ys = rng.uniform(-half_y, half_y, p)
    tx = rng.uniform(-0.02, 0.02, p)
    ty = rng.uniform(-slope_y, slope_y, p)
    inv = 1.0 / np.sqrt(tx * tx + ty * ty + 1.0)
    return tuple(np.asarray(a, np.float32) for a in
                 (xs, ys, np.full(p, 1.0e6), tx * inv, ty * inv, -inv))


class Scene:
    """A volume on both sides, its rays, and the window plan of the JAX
    side."""

    def __init__(self, vol, rays):
        self.jax_vol, self.rays = vol, rays
        self.torch_vol = port_volume(vol)
        self.plan = plan_windows(vol, *rays, require_profit=False)
        assert self.plan is not None
        self.jax_rays = tuple(jnp.asarray(a) for a in rays)

    def torch_rays(self):
        return [torch.from_numpy(a) for a in self.rays]


@pytest.fixture(scope="module")
def beyond_cap():
    """The 320 x 224 x 6 volume and 4096 rays of tests/test_march_window.py
    :364-393, with 64 rays moved beyond the +x face."""
    w, h, d = 320, 224, 6
    vol, vox, rng = _random_volume(w, h, d, seed=11, half_x=9e4)
    assert w * h > 256 * 256
    return Scene(vol, _downward(rng, 4096, 8.5e4, 0.45 * vox * h, 0.01,
                                outside=64))


@pytest.fixture(scope="module")
def unaligned():
    """140 x 116 x 8: W and H no multiples of 32 and 8 (:230-262)."""
    w, h, d = 140, 116, 8
    vol, vox, rng = _random_volume(w, h, d, seed=4, half_x=6e4)
    return Scene(vol, _downward(rng, 4096, 5.8e4, 0.48 * vox * h, 0.01))


@pytest.fixture(scope="module")
def wide():
    """256 x 64 x 8: partial windows along x (:173-206)."""
    w, h, d = 256, 64, 8
    vol, vox, rng = _random_volume(w, h, d, seed=3, half_x=12e4)
    return Scene(vol, _downward(rng, 4096, 11e4, 0.45 * vox * h, 0.005))


@pytest.fixture(scope="module")
def small_windowed():
    """The 64 x 64 x 8 volume and 2048 rays of the windowed gradient tests
    (:284-361); 2% of the rays start beyond the +x face."""
    return Scene(window_vol(n=64, d=8), window_chiefs(2048))


def _hold_windowed(got, ref, what):
    """Tolerance of tests/test_march_window.py: rtol 2e-4, atol 0.05 um for
    positions (f32 tap ordering on ~1e5 um coordinates) and 2e-5 for
    directions."""
    worst = []
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.numpy(), np.asarray(r)
        worst.append(float(np.abs(g - r).max()))
        np.testing.assert_allclose(g, r, rtol=2e-4,
                                   atol=0.05 if i < 3 else 2e-5,
                                   err_msg=f"{what}: output {i}")
    print(f"{what}: max abs difference, positions {max(worst[:3]):.3g} um, "
          f"directions {max(worst[3:]):.3g}")


# ---------------------------------------------------------------------------
# (a) the march against the windowed kernels themselves
# ---------------------------------------------------------------------------

WINDOWED_MENU = {
    "RK4 trilinear": dict(algorithm=2),
    "RK4 tricubic": dict(algorithm=2, interpolation_scheme=2),
    "Euler trilinear": dict(algorithm=1),
    "Euler tricubic": dict(algorithm=1, interpolation_scheme=2),
    "RK4 x 2 substeps": dict(algorithm=3, substeps=2),
}


@pytest.mark.parametrize("case", sorted(WINDOWED_MENU))
def test_march_matches_windowed_kernel_beyond_the_cap(beyond_cap, case):
    kw = WINDOWED_MENU[case]
    sc = beyond_cap
    ref = march_chief_windowed(sc.jax_vol, sc.plan, *sc.jax_rays, passes=3,
                               **kw)
    got = march_chief_fused(sc.torch_vol, *sc.torch_rays(), **kw)
    _hold_windowed(got, ref, case)
    # the rays beyond the +x face were bent by the clamped border voxels
    assert np.abs(got[3].numpy()[:64] - sc.rays[3][:64]).max() > 0


@pytest.mark.parametrize("which", ["unaligned", "wide"])
def test_march_matches_windowed_kernel_on_awkward_grids(request, which):
    """W and H that are no multiples of the TPU tiles (the reference pads
    with border-replicated voxels and clips in padded coordinates), and a
    wide slab with partial windows along x: both equal the clamp-and-fold
    rule of the gather."""
    sc = request.getfixturevalue(which)
    ref = march_chief_windowed(sc.jax_vol, sc.plan, *sc.jax_rays, passes=3)
    got = march_chief_fused(sc.torch_vol, *sc.torch_rays())
    _hold_windowed(got, ref, which)


# ---------------------------------------------------------------------------
# (b) all four integrators against the dense march with its cap lifted
# ---------------------------------------------------------------------------

DENSE_MENU = [(1, 1, None), (2, 1, None), (2, 2, None), (3, 1, 2),
              (4, 1, None), (4, 2, None)]


@pytest.mark.parametrize("algorithm,scheme,substeps", DENSE_MENU)
def test_march_matches_dense_oracle_beyond_the_cap(beyond_cap, monkeypatch,
                                                   algorithm, scheme,
                                                   substeps):
    """Tolerance of tests/test_torch_march.py (``_close``).  Adams-Bashforth
    is held here and not against the windowed kernel, which has no such
    branch and runs RK4 for algorithm 4."""
    monkeypatch.setattr(jmd, "DENSE_MAX_SLAB", 1 << 30)
    sc = beyond_cap
    kw = dict(algorithm=algorithm, interpolation_scheme=scheme,
              substeps=substeps)
    ref = jmd.march_chief_dense(sc.jax_vol, *sc.jax_rays,
                                use_pallas_sampler=False, **kw)
    got = march_chief_fused(sc.torch_vol, *sc.torch_rays(), **kw)
    _close([g.numpy() for g in got], ref,
           f"320x224x6 alg {algorithm} scheme {scheme}", _scale(sc.jax_vol))


def test_adams_bashforth_beyond_the_cap_is_not_rk4(beyond_cap):
    """The windowed kernel silently runs RK4 for algorithm 4; the port's
    Adams-Bashforth differs from its RK4 on the same rays."""
    sc = beyond_cap
    ab4 = march_chief_fused(sc.torch_vol, *sc.torch_rays(), algorithm=4)
    rk4 = march_chief_fused(sc.torch_vol, *sc.torch_rays(), algorithm=2)
    assert float((ab4[3] - rk4[3]).abs().max()) > 0


# ---------------------------------------------------------------------------
# (d) gradients
# ---------------------------------------------------------------------------

def _jax_loss(out):
    return jnp.sum(out[0] ** 2 + out[3] ** 2 * 1e6)


def _torch_field_grad(sc, loss=None, **kw):
    field = sc.torch_vol.field.clone().requires_grad_(True)
    out = march_chief_fused(sc.torch_vol._replace(field=field),
                            *sc.torch_rays(), **kw)
    value = (out[0] ** 2 + out[3] ** 2 * 1e6).sum() if loss is None \
        else loss(out)
    value.backward()
    return field.grad.numpy().ravel()


def _compare_grads(got, ref, what, rel_tol):
    ref = np.asarray(ref).ravel()
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"{what}: cosine {cos:.7f}, max difference {rel:.3g} of the "
          f"largest component (limit {rel_tol:g})")
    assert cos > 0.9999, cos
    assert rel < rel_tol, rel


@pytest.mark.parametrize("scheme", [1, 2])
@pytest.mark.parametrize("flavour", ["stage", "re-march"])
def test_field_gradient_matches_windowed_backward(small_windowed, monkeypatch,
                                                  scheme, flavour):
    """``jax.grad`` through the windowed backward kernel, over the saved
    stage states and by reverse re-march: 5e-4 of the largest component
    (tests/test_march_window.py:284-312)."""
    if flavour == "re-march":
        monkeypatch.setattr(jmw, "_win_traj_max_bytes", lambda: 0)
    sc = small_windowed
    ref = jax.grad(lambda f: _jax_loss(march_chief_windowed(
        sc.jax_vol._replace(field=f), sc.plan, *sc.jax_rays, algorithm=2,
        interpolation_scheme=scheme, passes=3)))(sc.jax_vol.field)
    got = _torch_field_grad(sc, algorithm=2, interpolation_scheme=scheme)
    _compare_grads(got, ref, f"scheme {scheme}, {flavour}", 5e-4)


def test_euler_field_gradient_matches_windowed_backward(small_windowed):
    sc = small_windowed
    ref = jax.grad(lambda f: _jax_loss(march_chief_windowed(
        sc.jax_vol._replace(field=f), sc.plan, *sc.jax_rays, algorithm=1,
        passes=3)))(sc.jax_vol.field)
    got = _torch_field_grad(sc, algorithm=1)
    _compare_grads(got, ref, "Euler", 5e-4)


def test_ray_gradient_matches_windowed_backward(small_windowed):
    """The cotangent of the entry z (tests/test_march_window.py:337-361):
    1e-5 of the largest component."""
    sc = small_windowed
    a = sc.jax_rays
    ref = np.asarray(jax.grad(lambda z0: _jax_loss(march_chief_windowed(
        sc.jax_vol, sc.plan, a[0], a[1], z0, *a[3:], algorithm=2,
        passes=3)))(a[2]))
    rays = sc.torch_rays()
    rays[2].requires_grad_(True)
    out = march_chief_fused(sc.torch_vol, *rays, algorithm=2)
    (out[0] ** 2 + out[3] ** 2 * 1e6).sum().backward()
    got = rays[2].grad.numpy()
    denom = np.abs(ref).max()
    assert denom > 0
    print(f"d loss / d z0: max difference "
          f"{np.abs(got - ref).max() / denom:.3g} of the largest component")
    np.testing.assert_allclose(got / denom, ref / denom, atol=1e-5)


def _deltas_loss_jax(deltas):
    return jnp.sum(deltas[1] ** 2 + deltas[3] ** 2 * 1e6)


def _torch_deltas_grad(sc, **kw):
    from photon_tpu_torch.ops.march_dense import chief_deltas_dense
    field = sc.torch_vol.field.clone().requires_grad_(True)
    deltas = chief_deltas_dense(sc.torch_vol._replace(field=field),
                                *sc.torch_rays(), **kw)
    (deltas[1] ** 2 + deltas[3] ** 2 * 1e6).sum().backward()
    return field.grad.numpy().ravel()


@pytest.fixture(scope="module")
def beyond_cap_rk4_grad(beyond_cap):
    """The port's RK4 field gradient on the 320 x 224 x 6 scene."""
    return _torch_deltas_grad(beyond_cap, algorithm=2)


def _windowed_deltas_grad(sc):
    return jax.grad(lambda f: _deltas_loss_jax(jmw.chief_deltas_windowed(
        sc.jax_vol._replace(field=f), sc.plan, *sc.jax_rays, algorithm=2,
        passes=3)))(sc.jax_vol.field)


def test_field_gradient_beyond_the_cap_matches_windowed_backward(
        beyond_cap, beyond_cap_rk4_grad):
    """The acceptance case of tests/test_march_window.py:364-412 with the
    windowed kernel as the reference: cosine above 0.9999, 1e-3 of the largest
    component."""
    ref = _windowed_deltas_grad(beyond_cap)
    _compare_grads(beyond_cap_rk4_grad, ref,
                   "320x224x6 against the windowed backward", 1e-3)


def test_reference_remarch_backward_is_off_on_the_coarse_noise_volume(
        beyond_cap, beyond_cap_rk4_grad, monkeypatch):
    """The windowed backward without its residual (reverse re-march with
    three defect corrections) on the same scene: its reconstruction does not
    converge on 0.08 kg/m^3 of voxel noise with slabs 177 voxels thick, and
    its gradient leaves the stage flavour's (and the port's) by far more than
    the 1e-3 that holds those two together.  The port's re-march kernel is
    the same iteration, so its dispatch measures the field first
    (``remarch_contraction``) and refuses this volume.  When the reference
    converges here, this test fails and the refusal can go."""
    monkeypatch.setattr(jmw, "_win_traj_max_bytes", lambda: 0)
    sc = beyond_cap
    ref = np.asarray(_windowed_deltas_grad(sc)).ravel()
    got = beyond_cap_rk4_grad
    rel = float(np.abs(got - ref).max() / np.abs(got).max())
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    print(f"320x224x6, the reference's re-march backward against the port's "
          f"gradient: max difference {rel:.3g} of the largest component, "
          f"cosine {cos:.7f}")
    assert np.isfinite(ref).all()
    assert rel > 1e-3, rel
    geom = mdf.march_geometry(sc.torch_vol)
    rate = mdf.remarch_contraction(sc.torch_vol.field, geom)
    print(f"remarch_contraction {rate:.3f} "
          f"(limit {mdf.REMARCH_MAX_CONTRACTION})")
    with pytest.raises(ValueError, match="cannot reconstruct"):
        mdf.defect_iterations(geom, rate)


def test_defect_corrections_follow_the_field(unaligned, small_windowed):
    """The anisotropy rule of the JAX package on smooth fields; more
    corrections where the field's lateral curvature slows the
    reconstruction (0.08 kg/m^3 of noise, more on 140 x 116 x 8 than on
    64 x 64 x 8); none suffice on the 320-wide noise volume (held above)."""
    geom = mdf.march_geometry(small_windowed.torch_vol)
    calm = mdf.remarch_contraction(small_windowed.torch_vol.field, geom)
    smooth = mdf.remarch_contraction(
        small_windowed.torch_vol.field.mean(dim=(1, 2), keepdim=True)
        .expand_as(small_windowed.torch_vol.field), geom)
    assert smooth == 0.0
    assert mdf.defect_iterations(geom, 1e-3) == mdf.defect_iterations(geom) \
        == 3
    # 0.08 kg/m^3 of noise is refused on 140 x 116 x 8 too (the one-sided
    # gradient stencil makes its border voxels four times as rough); a
    # quarter of it halves h sqrt(c) and converges with more corrections
    vol = unaligned.torch_vol
    geom = mdf.march_geometry(vol)
    noisy = mdf.remarch_contraction(vol.field, geom)
    base = vol.field.mean(dim=(1, 2), keepdim=True)
    quarter = mdf.remarch_contraction(base + 0.25 * (vol.field - base), geom)
    print(f"remarch_contraction on 140x116x8: {noisy:.3g} at 0.08 kg/m^3 of "
          f"noise, {quarter:.3g} at 0.02: "
          f"{mdf.defect_iterations(geom, quarter)} corrections (anisotropy "
          f"rule {mdf.defect_iterations(geom)})")
    assert noisy >= mdf.REMARCH_MAX_CONTRACTION > quarter > 0.1
    np.testing.assert_allclose(np.log1p(quarter), 0.5 * np.log1p(noisy),
                               rtol=1e-3)
    assert mdf.defect_iterations(geom, quarter) > mdf.defect_iterations(geom)


@pytest.mark.parametrize("algorithm,substeps", [(2, None), (3, 2), (4, None)])
def test_field_gradient_beyond_the_cap_matches_dense_oracle(
        beyond_cap, monkeypatch, request, algorithm, substeps):
    """The same against ``jax.grad`` of the dense march with its cap lifted.
    For RK4 with substeps and Adams-Bashforth the JAX package has no
    gradient on such a volume at all (its windowed backward raises); the
    port's falls out of the per-stage route."""
    monkeypatch.setattr(jmd, "DENSE_MAX_SLAB", 1 << 30)
    sc = beyond_cap
    kw = dict(algorithm=algorithm, substeps=substeps)
    ref = jax.grad(lambda f: _deltas_loss_jax(jmd.chief_deltas_dense(
        sc.jax_vol, *sc.jax_rays, field=f, use_pallas_sampler=False,
        **kw)))(sc.jax_vol.field)
    got = request.getfixturevalue("beyond_cap_rk4_grad") \
        if algorithm == 2 else _torch_deltas_grad(sc, **kw)
    _compare_grads(got, ref, f"320x224x6 alg {algorithm} against the dense "
                   f"oracle", 1e-3)


def test_windowed_gradient_of_substeps_raises_in_the_reference(beyond_cap):
    """What the test above says of the reference, held: when this stops
    raising, the windowed kernel becomes the reference for that case."""
    sc = beyond_cap
    with pytest.raises(NotImplementedError, match="substeps=1"):
        jax.grad(lambda f: _jax_loss(march_chief_windowed(
            sc.jax_vol._replace(field=f), sc.plan, *sc.jax_rays, algorithm=3,
            substeps=2, passes=3)))(sc.jax_vol.field)


# ---------------------------------------------------------------------------
# (e) choose_substeps on a large slab
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sheet300():
    """The steep Gaussian z-sheet of tests/test_march_dense.py:78-96 on a
    300 x 300 slab, with enough rays for a window plan."""
    n, d = 300, 12
    extent, z0, z1 = 2.4e5, 4.0e5, 9.0e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z = np.linspace(z0, z1, d)
    dzs = z[1] - z[0]
    zc = 0.5 * (z0 + z1) + 0.37 * dzs
    sh = np.exp(-((z - zc) / (0.25 * dzs)) ** 2)
    gx = (x - x.min()) / (x.max() - x.min())
    rho = 1.225 + 12.0 * gx[:, None, None] * sh[None, None, :] \
        * np.ones((1, n, 1))
    vol = build_density_volume(rho, [x[1] - x[0], x[1] - x[0], dzs],
                               [x[0], x[0], z0])
    rng = np.random.default_rng(5)
    p = 2048
    rays = (rng.uniform(-0.8e5, 0.8e5, p), rng.uniform(-0.8e5, 0.8e5, p),
            np.full(p, 1.0e6), np.zeros(p), np.zeros(p), np.full(p, -1.0))
    return vol, port_volume(vol), tuple(np.asarray(a, np.float32)
                                        for a in rays)


@pytest.mark.parametrize("kw", [dict(), dict(budget=1e-12)])
def test_choose_substeps_on_a_large_slab_matches_jax(sheet300, kw):
    """The JAX package probes through its windowed march on a plan of the
    subsample; the port through the one march.  Same count."""
    jv, tv, rays = sheet300
    assert not jmd.dense_march_supported(jv)
    want = jmd.choose_substeps(jv, *(jnp.asarray(a) for a in rays), **kw)
    got = choose_substeps(tv, *(torch.from_numpy(a) for a in rays), **kw)
    print(f"choose_substeps({kw}) on a 300 x 300 slab: {got} "
          f"(JAX package: {want})")
    assert got == want
    assert got == (16 if kw else 2)


def test_choose_substeps_on_a_large_slab_at_a_tight_budget(sheet300,
                                                           monkeypatch):
    """Between those two the JAX package's windowed probes answer with their
    own rounding: they run the default two-pass bf16 contraction, whose
    ~1e-3 relative error swamps the Richardson difference of the 2- and
    4-substep marches (budget 1e-3 .. 1e-5: 4, 4, 8 there, 2 here and in
    f32).  The count is therefore held against the JAX package's f32 branch
    (the dense march with its cap lifted)."""
    jv, tv, rays = sheet300
    kw = dict(budget=1e-6, max_substeps=64)
    monkeypatch.setattr(jmd, "DENSE_MAX_SLAB", 1 << 30)
    want = jmd.choose_substeps(jv, *(jnp.asarray(a) for a in rays), **kw)
    got = choose_substeps(tv, *(torch.from_numpy(a) for a in rays), **kw)
    print(f"choose_substeps({kw}) on a 300 x 300 slab: {got} (JAX package, "
          f"f32 dense branch: {want})")
    assert got == want and 2 < got < 64


# ---------------------------------------------------------------------------
# (i) limits and budgets of the kernels' wrappers
# ---------------------------------------------------------------------------

def _meta_march(w, h, requires_grad=False):
    field = torch.empty((3, h, w, 4), device="meta",
                        requires_grad=requires_grad)
    rays = [torch.empty(8, device="meta") for _ in range(6)]
    return field, rays


@pytest.mark.parametrize("route", ["plain head", "residual head", "sampler"])
def test_slab_of_2_to_the_31_voxels_raises(route):
    """A voxel's offset inside its slab is a 32-bit integer in the kernels:
    the wrappers say so instead of launching (meta tensors stand for the
    card)."""
    w, h = 65536, 32768
    with pytest.raises(ValueError, match="fewer than 2\\^31 voxels"):
        if route == "sampler":
            slab = torch.empty((h, w, 4), device="meta")
            u = torch.empty(8, device="meta")
            mds.slab_sample_forward(slab, slab, u, u, u, 1)
        else:
            field, rays = _meta_march(w, h, route == "residual head")
            geom = np.zeros(8, np.float32)
            if route == "plain head":
                mdf.march_forward_noresidual(field, rays, geom, 2, 1)
            else:
                mdf.march_forward_residual(field, torch.stack(rays), geom, 2,
                                           True)


def test_a_large_slab_reaches_the_kernel_on_the_card(monkeypatch):
    """No size routes a CUDA tensor anywhere but to the march kernel (its
    library load stands for it here)."""
    class Reached(Exception):
        pass

    def load(name):
        raise Reached(name)

    monkeypatch.setattr(mdf.kernels, "load", load)
    field, rays = _meta_march(300, 300)
    vol = port_volume(window_vol(n=16, d=8))._replace(field=field)
    with pytest.raises(Reached, match="march_dense"):
        march_chief_fused(vol, *rays, algorithm=2)


def test_residual_budget_by_slab_size():
    """2 GB up to a 256 x 256 slab, 6 GB above, as the JAX package's dense
    and windowed marches; the bench's 512^3 residual (120,000 rays x 511
    slabs x 20 floats) fits the second only."""
    assert mdf.traj_max_bytes(256, 256) == 2 << 30 == mdf.TRAJ_MAX_BYTES
    assert mdf.traj_max_bytes(257, 256) == 6 << 30
    bench = 120_000 * 511 * mdf.stage_rows(2) * 4
    assert mdf.TRAJ_MAX_BYTES < bench <= mdf.traj_max_bytes(512, 512)
    assert jmw._win_traj_max_bytes() == mdf.TRAJ_MAX_BYTES_LARGE


def test_launch_counters_tell_the_tiers_apart():
    class Wrapper:
        launches = launches_large = 0

    mds.count_launch(Wrapper, 256, 256)
    assert (Wrapper.launches, Wrapper.launches_large) == (1, 0)
    mds.count_launch(Wrapper, 288, 288)
    assert (Wrapper.launches, Wrapper.launches_large) == (2, 1)
    for fn in (mdf.march_chief_fused, mdf.march_backward_stage,
               mdf.march_backward_remarch, mds.slab_sample_forward,
               mds.slab_sample_backward):
        assert fn.launches_large <= fn.launches
