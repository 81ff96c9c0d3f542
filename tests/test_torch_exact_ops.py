"""Port vs JAX: the exact path's lens, interpolation and sensor operations
(``ops/lens.py``, ``ops/interp.py``, ``ops/sensor.py``) on the CPU, on the
same seeded numpy inputs.

Tolerances.  The JAX package's float32 ``sqrt`` on the CPU is not always the
correctly rounded one (the port's is): on the default camera's thick lens
about 2% of the rays' discriminant roots differ by one ulp.  The
intersection ``-beta - sqrt(disc)`` cancels from ~2e8 (guard PR 1), so those
rays move by up to ~10 um at the lens, 1e-7 of the coordinates' scale, and
their directions by ~1e-6.  Rays are therefore compared on a common scale:
the same rays culled, and every finite component within a stated share of
the largest magnitude of its field (positions, directions, wavelengths,
radiances).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import photon_tpu.ops.interp as jinterp
import photon_tpu.ops.lens as jlens
import photon_tpu.ops.sensor as jsensor
from photon_tpu.config import default_config as jax_default_config
from photon_tpu.models.optics import OpticalAssembly as JaxAssembly
from photon_tpu.models.optics import OpticalElement as JaxElement
from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.optics import \
    create_camera_optical_system as jax_camera_system
from photon_tpu.models.optics import flatten_assembly as jax_flatten
from photon_tpu_torch.config import default_config
from photon_tpu_torch.models.optics import (OpticalAssembly, OpticalElement,
                                            camera_setup,
                                            create_camera_optical_system,
                                            flatten_assembly)
from photon_tpu_torch.ops import interp, lens, sensor
from photon_tpu_torch.ops.march_dense import bspline_prefilter

T = torch.as_tensor


def _jax_bundle(b):
    return jlens.RayBundle(*(jnp.asarray(a) for a in b))


def _port_bundle(b):
    return lens.RayBundle(*(torch.tensor(a) for a in b))


def assert_rays_close(got, ref, tol, pos_tol=None):
    """The same rays culled; each finite field within ``tol`` (positions:
    ``pos_tol``, default ``tol``) of its largest magnitude (a common scale:
    a position's three components share one)."""
    for name, g, r in zip(ref._fields, got, ref):
        g = g.numpy()
        r = np.asarray(r)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r),
                                      err_msg=name)
        fin = np.isfinite(r)
        if not fin.any():
            continue
        gg = np.where(fin, g, 0.0)
        rr = np.where(fin, r, 0.0)
        err = np.abs(gg - rr).max() / max(np.abs(rr).max(), 1e-30)
        print(f"    {name}: {err:.3g} of its largest magnitude")
        assert err <= (pos_tol if name == "pos" and pos_tol else tol), \
            (name, err)


def camera_rays(n_src=6, rays=48, seed=0, wavelength=0.532, cone=0.4):
    """Rays from object points of the default BOS camera toward a cone of
    radius ``cone`` x the lens pitch around its axis, built in float32 numpy
    from a seed: (pos, dir, wavelength, radiance), plus both packages'
    camera setups."""
    jsetup = jax_camera_setup(jax_default_config("bos"))
    rng = np.random.default_rng(seed)
    half = 0.7 * 256 * 17.0 / 2.0 / jsetup.magnification
    xs = rng.uniform(-half, half, n_src)
    ys = rng.uniform(-half, half, n_src)
    z = jsetup.z_object
    r1, r2 = rng.random(rays), rng.random(rays)
    xl = cone * jsetup.lens_pitch * r1 * np.cos(2 * np.pi * r2)
    yl = cone * jsetup.lens_pitch * r1 * np.sin(2 * np.pi * r2)
    tx = -(xl[None] - xs[:, None]) / (jsetup.image_distance - z)
    ty = -(yl[None] - ys[:, None]) / (jsetup.image_distance - z)
    d = np.stack([tx, ty, -np.ones_like(tx)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    pos = np.broadcast_to(np.stack([xs, ys, np.full(n_src, z)], -1)[:, None],
                          d.shape)
    n = n_src * rays
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    bundle = (f32(pos.reshape(n, 3)), f32(d.reshape(n, 3)),
              f32(np.full(n, wavelength)), f32(rng.uniform(0.5, 2.0, n)))
    return bundle, jsetup, camera_setup(default_config("bos"))


def element_stacks(z_lens, *elements):
    """Both packages' flattened trains of the OpticalElement keyword sets
    ``elements`` (in light order last to first), placed at ``z_lens``."""
    return [flatten(Assembly(elements=[El(**kw) for kw in elements]))
            .offset_z(float(z_lens))
            for El, Assembly, flatten in (
                (JaxElement, JaxAssembly, jax_flatten),
                (OpticalElement, OpticalAssembly, flatten_assembly))]


# ---------------------------------------------------------------------------
# lens
# ---------------------------------------------------------------------------

def test_sphere_hits_and_misses():
    rng = np.random.default_rng(1)
    n = 64
    origin = np.stack([rng.uniform(-3e4, 3e4, n), rng.uniform(-3e4, 3e4, n),
                       np.full(n, 5e5)], -1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n),
                  -np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    origin[:8, 0] = 4e5                  # these miss the sphere
    center = np.array([0.0, 0.0, -1e5], np.float32)
    for radius, surface in ((2e5, "front"), (-2e5, "back")):
        ref = np.asarray(jlens.ray_sphere_intersection(
            jnp.asarray(center), radius, jnp.asarray(d), jnp.asarray(origin),
            surface))
        got = lens.ray_sphere_intersection(T(center), radius, T(d),
                                           T(origin), surface).numpy()
        assert np.isnan(got[:8]).all() and np.isfinite(got[8:]).all()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        # common scale: 1e-6 of the coordinates' largest magnitude
        scale = np.abs(ref[8:]).max()
        assert np.abs(got[8:] - ref[8:]).max() <= 1e-6 * scale


def test_distance_to_optical_axis():
    rng = np.random.default_rng(2)
    pos = rng.normal(0, 1e4, (32, 3)).astype(np.float32)
    c = np.array([10.0, -20.0, 5.0], np.float32)
    n = np.array([0.02, 0.0, 1.0], np.float32)
    ref = np.asarray(jlens.distance_to_optical_axis(
        jnp.asarray(pos), jnp.asarray(c), jnp.asarray(n)))
    got = lens.distance_to_optical_axis(T(pos), T(c), T(n)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# a biconvex element of OpticalElement's defaults (100 mm pitch, radii
# +200 / -400 mm, 10 mm thick, n 1.5), strong enough that dispersion and the
# glass path show
LENS_CASES = {
    "thin lens": dict(model="thin-lens"),
    "thick lens": dict(model="general"),
    "biconvex lens": dict(model="general", element={}),
    "biconvex lens, Abbe dispersion": dict(
        model="general", element=dict(abbe_number=40.0)),
    "biconvex lens, absorbance": dict(
        model="general", element=dict(absorbance_rate=0.2)),
    "biconvex lens, Abbe and absorbance": dict(
        model="general", element=dict(abbe_number=55.0,
                                      absorbance_rate=0.05)),
}


@pytest.mark.parametrize("case", sorted(LENS_CASES))
def test_lens_matches_jax(case):
    """One lens through both packages' propagate_system: the default
    camera's own (nearly flat) lens, or a biconvex element at its place.
    The wavelength is 532 nm, so that the Cauchy term (wavelengths in nm,
    ref: :618-643) bends rays.  Tolerance: 1e-5 of each field's scale (the
    sqrt ulp above)."""
    kw = LENS_CASES[case]
    bundle, jsetup, tsetup = camera_rays(wavelength=532.0)
    stacks = [jsetup.elements, tsetup.elements]
    if "element" in kw:
        stacks = element_stacks(jsetup.z_lens, kw["element"])
    ref = jlens.propagate_system(_jax_bundle(bundle), stacks[0], kw["model"])
    got = lens.propagate_system(_port_bundle(bundle), stacks[1], kw["model"])
    assert np.isfinite(np.asarray(ref.pos)).all(axis=-1).mean() > 0.5
    assert_rays_close(got, ref, 1e-5)
    if kw.get("element"):
        # the option changes what comes out
        plain = lens.propagate_system(
            _port_bundle(bundle), element_stacks(jsetup.z_lens, {})[1],
            kw["model"])
        moved = max(float(torch.nan_to_num(a - b).abs().max())
                    for a, b in ((got.dir, plain.dir),
                                 (got.radiance, plain.radiance)))
        assert moved > 1e-4, moved


def test_aperture_culls_rays():
    """tests/test_optics.py:108-126 through both packages: the stop keeps
    |x| <= 50 exactly."""
    n = 11
    xs = np.linspace(-100.0, 100.0, n).astype(np.float32)
    bundle = (np.stack([xs, np.zeros(n), np.full(n, 50.0)], -1)
              .astype(np.float32),
              np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n, 1)),
              np.zeros(n, np.float32), np.ones(n, np.float32))
    center = np.zeros(3, np.float32)
    plane = np.array([0.0, 0.0, 1.0, 0.0], np.float32)
    ref = jlens.propagate_aperture(_jax_bundle(bundle), jnp.asarray(center),
                                   jnp.asarray(plane), pitch=100.0,
                                   vertex_distance=2.0)
    got = lens.propagate_aperture(_port_bundle(bundle), T(center), T(plane),
                                  pitch=100.0, vertex_distance=2.0)
    np.testing.assert_array_equal(got.valid.numpy(), np.abs(xs) <= 50.0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("model", ["thin-lens", "general"])
def test_lens_stop_lens_train_matches_jax(model):
    """A lens, a stop that culls the outer rays, and a second lens
    (tests/test_optics.py:93-106), at the camera's lens position."""
    bundle, jsetup, _ = camera_rays()
    stacks = element_stacks(
        jsetup.z_lens, dict(vertex_distance=5e3, z_inter_element_distance=2e3),
        dict(element_type="aperture", pitch=6e3, vertex_distance=1e3,
             z_inter_element_distance=3e3),
        dict(vertex_distance=4e3))
    assert stacks[1].num_elements == 3
    ref = jlens.propagate_system(_jax_bundle(bundle), stacks[0], model)
    got = lens.propagate_system(_port_bundle(bundle), stacks[1], model)
    live = np.asarray(ref.valid)
    # the stop culls some rays and passes others
    assert 0.1 * len(live) < live.sum() < 0.9 * len(live)
    assert_rays_close(got, ref, 1e-5)


def test_tilted_biconvex_lens_matches_jax():
    """The biconvex element tilted by 0.02 rad about x and shifted off the
    axis: 1e-5 of each field's scale."""
    bundle, jsetup, _ = camera_rays()
    stacks = element_stacks(jsetup.z_lens, dict(
        rotation_angles=(0.02, 0.0, 0.0), axial_offset_distances=(300.0,
                                                                   -200.0)))
    assert not np.allclose(stacks[1].plane_parameters[0][:3], [0, 0, 1])
    ref = jlens.propagate_system(_jax_bundle(bundle), stacks[0], "general")
    got = lens.propagate_system(_port_bundle(bundle), stacks[1], "general")
    assert_rays_close(got, ref, 1e-5)


def test_tilted_camera_lens_matches_jax_op_by_op():
    """The camera's own lens tilted by 0.02 rad about x (as in
    tests/test_torch_render.py's 'tilted train').  That lens is 0.43 um
    thick with radii of 1e8 um, and the lensmaker's equation gives it an
    index of 477: the exit refraction multiplies one ulp of a surface
    normal into up to ~3e-3 of a direction.  The JAX package's jitted and
    op-by-op (``jax.disable_jit``) runs differ on 99 of these 288 rays, by
    up to 2.8e-3.  So the port is held to the op-by-op run: the same rays
    culled, 90% of the rays' directions within 1e-5 and the rest within
    3e-3, positions within 1e-4 of their scale (the hit moves ~8 um along
    the ray with one ulp of the root)."""
    def tilted(system, setup_of, cfg):
        assembly = system(cfg)
        el = assembly.elements[0]
        while not hasattr(el, "front_surface_radius"):
            el = el.elements[0]
        el.rotation_angles = (0.02, 0.0, 0.0)
        return setup_of(cfg, assembly)
    bundle, _, _ = camera_rays()
    js = tilted(jax_camera_system, jax_camera_setup,
                jax_default_config("bos"))
    ts = tilted(create_camera_optical_system, camera_setup,
                default_config("bos"))
    assert not np.allclose(ts.elements.plane_parameters[0][:3], [0, 0, 1])
    with jax.disable_jit():
        ref = jlens.propagate_system(_jax_bundle(bundle), js.elements,
                                     "general")
    got = lens.propagate_system(_port_bundle(bundle), ts.elements, "general")
    assert_rays_close(got, ref, 3e-3, pos_tol=1e-4)
    err = np.nan_to_num(np.abs(got.dir.numpy() - np.asarray(ref.dir))
                        .max(axis=-1))
    print(f"directions beyond 1e-5: {int((err > 1e-5).sum())} of {len(err)}")
    assert (err > 1e-5).mean() <= 0.1


# ---------------------------------------------------------------------------
# interpolation (the cases of tests/test_interp.py, held to the JAX package)
# ---------------------------------------------------------------------------

def _both_flat(field):
    flat = field.reshape(-1, field.shape[-1])
    return jnp.asarray(flat), T(flat.copy())


def _both_sample(fn_name, field, sizes, lookup):
    jf, tf = _both_flat(field)
    ref = np.asarray(getattr(jinterp, fn_name)(jf, sizes,
                                               jnp.asarray(lookup)))
    got = getattr(interp, fn_name)(tf, sizes, T(lookup)).numpy()
    return got, ref


def test_trilinear_at_voxel_centres_and_between():
    rng = np.random.default_rng(0)
    W, H, D = 6, 5, 4
    field = rng.random((D, H, W, 2)).astype(np.float32)
    xs, ys, zs = np.meshgrid(np.arange(W), np.arange(H), np.arange(D),
                             indexing="ij")
    centres = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5,
                        zs.ravel() + 0.5], -1)
    between = rng.uniform(-1.0, [W + 1, H + 1, D + 1], (200, 3))
    lookup = np.concatenate([centres, between]).astype(np.float32)
    got, ref = _both_sample("sample_trilinear", field, (W, H, D), lookup)
    np.testing.assert_array_equal(got[:len(centres)],
                                  field[zs.ravel(), ys.ravel(), xs.ravel()])
    # test_interp.py's tolerance at voxel centres (rtol 1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_trilinear_midpoint_and_clamp():
    field = np.arange(27, dtype=np.float32).reshape(3, 3, 3, 1)
    lookup = np.array([[1.0, 0.5, 0.5], [-5.0, 0.5, 0.5], [50.0, 0.5, 0.5],
                       [0.5, 50.0, -50.0]], np.float32)
    got, ref = _both_sample("sample_trilinear", field, (3, 3, 3), lookup)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 0.5 and got[1, 0] == 0.0 and got[2, 0] == 2.0


def test_texture_lookup_and_predicates():
    rng = np.random.default_rng(3)
    lo = np.array([-1.0, -2.0, 0.0], np.float32)
    hi = np.array([10.0, 8.0, 20.0], np.float32)
    pos = rng.uniform(lo - 3, hi + 3, (300, 3)).astype(np.float32)
    pos[0] = lo
    pos[1] = hi
    sizes = (8, 6, 10)
    jl = jinterp.texture_lookup(jnp.asarray(pos), jnp.asarray(lo),
                                jnp.asarray(hi), sizes)
    tl = interp.texture_lookup(T(pos), T(lo), T(hi), sizes)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tl.numpy()[:2], [[1.0, 1.0, 1.0],
                                                [7.0, 5.0, 9.0]])
    np.testing.assert_array_equal(
        interp.inside_box(T(pos), tl, T(lo), T(hi), sizes).numpy(),
        np.asarray(jinterp.inside_box(jnp.asarray(pos), jl, jnp.asarray(lo),
                                      jnp.asarray(hi), sizes)))
    np.testing.assert_array_equal(
        interp.can_access(tl, sizes).numpy(),
        np.asarray(jinterp.can_access(jl, sizes)))


def test_prefilters_agree():
    """The port's float32 prefilter (ops/march_dense.bspline_prefilter, on
    the device) against the JAX exact path's float64 numpy one: within
    2e-6 of the field's range (the recursion's float32 rounding)."""
    rng = np.random.default_rng(1)
    field = rng.random((9, 10, 11, 4)).astype(np.float32)
    ref = jinterp.bspline_prefilter(field)
    got = bspline_prefilter(T(field)).numpy()
    err = np.abs(got - ref).max() / np.abs(field).max()
    print(f"prefilters: {err:.3g} of the field's maximum")
    assert err <= 2e-6, err


def test_tricubic_reproduces_samples_and_matches_jax():
    """test_interp.py's prefilter-then-interpolate property (atol 2e-5)
    through the port's prefilter, and the port's tricubic sample against
    the JAX package's on the same coefficients (rtol 1e-5)."""
    rng = np.random.default_rng(1)
    W = H = D = 10
    field = rng.random((D, H, W, 1)).astype(np.float32)
    coeffs = bspline_prefilter(T(field)).numpy()
    xs, ys, zs = np.meshgrid(np.arange(2, W - 2), np.arange(2, H - 2),
                             np.arange(2, D - 2), indexing="ij")
    centres = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5,
                        zs.ravel() + 0.5], -1).astype(np.float32)
    got, ref = _both_sample("sample_tricubic", coeffs, (W, H, D), centres)
    np.testing.assert_allclose(got[:, 0], field[zs.ravel(), ys.ravel(),
                                                xs.ravel(), 0], atol=2e-5)
    anywhere = rng.uniform(-2.0, 12.0, (300, 3)).astype(np.float32)
    got, ref = _both_sample("sample_tricubic", coeffs, (W, H, D), anywhere)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_tricubic_linear_field():
    """A linear field comes back exactly away from the clamped border
    (test_interp.py's atol 2e-3), through the port's prefilter."""
    W = H = D = 12
    xs, ys, zs = np.meshgrid(np.arange(W), np.arange(H), np.arange(D),
                             indexing="ij")
    lin = (0.5 * xs + 0.25 * ys - 0.1 * zs).astype(np.float32)
    field = np.ascontiguousarray(lin.transpose(2, 1, 0)[..., None])
    coeffs = bspline_prefilter(T(field))
    pts = np.array([[4.3, 5.7, 6.1], [3.9, 4.2, 5.5]], np.float32)
    out = interp.sample_tricubic(coeffs.reshape(-1, 1), (W, H, D),
                                 T(pts + 0.5)).numpy()
    expected = 0.5 * pts[:, 0] + 0.25 * pts[:, 1] - 0.1 * pts[:, 2]
    np.testing.assert_allclose(out[:, 0], expected, atol=2e-3)


# ---------------------------------------------------------------------------
# sensor (the cases of tests/test_sensor.py, held to the JAX package at that
# file's tolerance against its loop oracle: rtol 2e-4, atol 1e-5)
# ---------------------------------------------------------------------------

def _sensor_inputs(n, nx, ny, pitch, seed, slope=(0.05, -0.02)):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(-pitch * nx / 2, pitch * nx / 2, n)
    pos[:, 1] = rng.uniform(-pitch * ny / 2, pitch * ny / 2, n)
    d = np.tile(np.array([[slope[0], slope[1], -1.0]], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rad = rng.uniform(0.5, 2.0, n).astype(np.float32)
    valid = np.ones(n, bool)
    return pos, d, rad, valid


def _splats(fn_name, inputs, **kw):
    ref = np.asarray(getattr(jsensor, fn_name)(
        *(jnp.asarray(a) for a in inputs), **kw))
    got = getattr(sensor, fn_name)(*(T(a) for a in inputs), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    return got, ref


@pytest.mark.parametrize("rf", [0.75, 1.0])
def test_diffraction_splat_matches_jax(rf):
    inputs = _sensor_inputs(64, 32, 24, 17.0, seed=3)
    got, ref = _splats("diffraction_splat", inputs, nx=32, ny=24,
                       pixel_pitch=17.0, diameter=3.0, render_fraction=rf)
    assert ref.sum() > 0
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


def test_diffraction_splat_unmirrored_and_wide_spot():
    inputs = _sensor_inputs(40, 20, 20, 10.0, seed=4, slope=(0.0, 0.0))
    got, ref = _splats("diffraction_splat", inputs, nx=20, ny=20,
                       pixel_pitch=10.0, diameter=5.5, render_fraction=0.75,
                       mirror_x=False)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


def test_invalid_nan_and_offsensor_rays_drop():
    """Rays off the sensor, flagged invalid, or NaN (the lens's culling)
    deposit nothing; only the one good ray lands."""
    pos = np.array([[1e7, 0, 0], [0, 0, 0], [np.nan, 0, 0], [5, 5, 0],
                    [0, -1e9, 0], [20, 0, 0]], np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (6, 1))
    d[3] = np.nan
    rad = np.ones(6, np.float32)
    # a bundle's valid mask (finite positions and directions), and one ray
    # culled by the flag alone
    valid = np.isfinite(pos).all(-1) & np.isfinite(d).all(-1)
    valid[5] = False
    kw = dict(nx=16, ny=16, pixel_pitch=17.0, diameter=3.0)
    got, ref = _splats("diffraction_splat", (pos, d, rad, valid), **kw)
    one, _ = _splats("diffraction_splat", (pos[1:2], d[1:2], rad[1:2],
                                           valid[1:2]), **kw)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(got, one)
    got, ref = _splats("bilinear_splat", (pos, d, rad, valid), nx=16, ny=16,
                       pixel_pitch=17.0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert np.isfinite(got).all()


def test_diffraction_energy_at_centre():
    pos = np.zeros((1, 3), np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    got, ref = _splats("diffraction_splat",
                       (pos, d, np.ones(1, np.float32), np.ones(1, bool)),
                       nx=64, ny=64, pixel_pitch=17.0, diameter=3.0)
    assert 0.85 < float(got.sum()) < 1.05
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("legacy", [True, False])
def test_bilinear_splat_matches_jax(legacy):
    """The bilinear sensor (test_sensor.py's rtol 1e-4, atol 1e-6); rays on
    the first row and column, whose legacy-shifted index is negative and
    goes to the JAX package's sentinel, deposit nothing there."""
    pos, d, rad, valid = _sensor_inputs(128, 24, 24, 17.0, seed=7,
                                        slope=(0.1, 0.1))
    edge = -17.0 * 23 / 2.0
    pos[:6, 0] = edge + np.linspace(0.05, 0.9, 6) * 17.0     # column 0
    pos[6:12, 1] = edge + np.linspace(0.05, 0.9, 6) * 17.0   # row 0
    got, ref = _splats("bilinear_splat", (pos, d, rad, valid), nx=24, ny=24,
                       pixel_pitch=17.0, legacy_index_shift=legacy)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert ref.sum() > 0


def test_cos4_and_sensor_coordinates():
    rng = np.random.default_rng(9)
    d = rng.normal(0, 0.1, (50, 3)).astype(np.float32)
    d[:, 2] = -1.0
    np.testing.assert_allclose(sensor.cos4_falloff(T(d)).numpy(),
                               np.asarray(jsensor.cos4_falloff(
                                   jnp.asarray(d))), rtol=1e-6)
    xy = rng.uniform(-300, 300, (50, 2)).astype(np.float32)
    for mirror in (True, False):
        a = sensor.sensor_coordinates(T(xy), 17.0, 32, 24, mirror)
        b = jsensor.sensor_coordinates(jnp.asarray(xy), 17.0, 32, 24, mirror)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v))
    assert sensor._splat_window(3.0, 0.75) == jsensor._splat_window(3.0, 0.75)
    assert math.isclose(sensor._SQRT8, float(np.float32(math.sqrt(8.0))))
