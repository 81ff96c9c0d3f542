"""The port's kernels against their plain versions on the card, at a small
size: the march (K1, both heads, both schemes, two rays a thread under the
trilinear one) against the plain march, rays in input order and shuffled;
the stagewise march (Adams-Bashforth, RK4 with substeps) and its backward
against the plain march and autograd through it, both schemes, one slab over
256 x 256;
the fan statistics (K2) against the plain fan, three lens models; the
march's stage and re-march backward (K4, K5) against autograd through the
plain march, both schemes, rays in bunches that share voxels (the merged
scatter) and scattered rays (the direct one), and the cubic gradient route
in its block order against the same kernels in the caller's order; the
fan's backward (K6)
against autograd through the plain fan, three lens models; the sampler's
backward (K9), which shares K4's scatter; the splat (K3) against the plain
splat and its transpose (K7) against autograd through it, on spots in runs
of 120 that share a dot (the bench's order; runs of the kernel straddle two
dots), dots spread over 24 px, scattered spots and zero-amplitude
particles, in launches that give a warp 1, 2, 8, 16 and 32 particles, and
a K = 40 patch on a small frame; the gradient precompute (K10) against
the plain stencil bit for bit, the prefilter (K11) against the plain
prefilter and its transpose (K12) against autograd through it, bit for bit,
on both of their routes (tiles, and one thread a line) and on ragged and
misaligned fields; K10's transpose (K13) against its plain version bit for
bit, and volume_from_rho and invert_bos on the card through K10 and K13;
the exact path's cubic weights and its RK4 march under
both schemes against the CPU, bit for bit.

Each test skips without a CUDA device.  This file imports no jax, so it runs
where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from photon_tpu_torch import native
from photon_tpu_torch.inverse import invert_bos, volume_from_rho
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.ops import interp
from photon_tpu_torch.ops import march as exact_march
from photon_tpu_torch.ops.fan import fan_stats, fan_stats_plain
from photon_tpu_torch.ops.lens import RayBundle
from photon_tpu_torch.ops.march_dense import (bspline_prefilter,
                                              bspline_prefilter_plain,
                                              march_chief_dense,
                                              march_geometry)
from photon_tpu_torch.ops.march_dense_fused import (march_chief_fused,
                                                    march_forward_residual,
                                                    march_forward_stagewise)
from photon_tpu_torch.ops.march_dense_sampler import (slab_sample_backward,
                                                      slab_sample_plain)
from photon_tpu_torch.ops.splat import (splat_backward, splat_particles,
                                        splat_particles_plain)
from photon_tpu_torch.volume import build_density_volume
from torch_port_helpers import fan_inputs, small_bos_scene

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _nerr(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _march_scene(dev, p=3000, n=12, seed=3, nxy=None):
    """A random 12^3 volume; rays in bunches of 40 that share their voxels
    (the source points of a dot), then scattered ones, some starting inside
    or below the volume or travelling up; p is no multiple of 32.  With
    `nxy`, an nxy x nxy x n volume of a smooth density instead: on voxel
    noise at 260 voxels across, the rays cross a voxel face of the
    trilinear gradient at every few microns, and the plain march's own f32
    gradient differs from its f64 one by 6e-3..8e-2 of the maximum (K4's
    from the plain march by 4.8e-2; NVIDIA H100 80GB HBM3, 700 W), so no
    kernel can be held to 5e-4 there."""
    rng = np.random.default_rng(seed)
    nxy = nxy or n
    rx = np.linspace(-6e4, 6e4, nxy)
    rz = np.linspace(4.0e5, 9.0e5, n)
    if nxy == n:
        rho = 1.2 + 0.8 * rng.random((n, n, n))
    else:
        u = np.linspace(0.0, 1.0, nxy)
        w = np.linspace(0.0, 1.0, n)
        rho = 1.2 + 0.4 * (1.0 + np.sin(2.0 * np.pi * (1.3 * u + 0.2))[
            :, None, None] * np.cos(2.0 * np.pi * 0.9 * u)[None, :, None]
            * (0.6 + 0.4 * np.sin(2.0 * np.pi * w))[None, None, :])
    vol = build_density_volume(
        rho, [rx[1] - rx[0]] * 2
        + [rz[1] - rz[0]], [rx[0], rx[0], rz[0]], device=dev)
    b = p // 40 + 1
    x0 = np.repeat(rng.uniform(-4e4, 4e4, b), 40)[:p] + rng.uniform(-200, 200, p)
    y0 = np.repeat(rng.uniform(-4e4, 4e4, b), 40)[:p] + rng.uniform(-200, 200, p)
    tx = np.repeat(rng.uniform(-0.05, 0.05, b), 40)[:p]
    ty = np.repeat(rng.uniform(-0.05, 0.05, b), 40)[:p]
    half = p // 2
    x0[half:] = rng.uniform(-5e4, 5e4, p - half)
    tx[half:] = rng.uniform(-0.05, 0.05, p - half)
    inv = 1.0 / np.sqrt(tx * tx + ty * ty + 1.0)
    z0 = np.full(p, 1.0e6)
    z0[100:140] = rng.uniform(4.5e5, 8.5e5, 40)
    z0[140:150] = 3.0e5
    rays = [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (x0, y0, z0, tx * inv, ty * inv, -inv)]
    rays[5][150:160] = -rays[5][150:160]
    gen = torch.Generator(device=dev).manual_seed(seed)
    cts = [torch.randn(p, generator=gen, device=dev) * s
           for s in (1.0, 1.0, 1.0, 1e5, 1e5, 1e5)]
    return vol, rays, cts


def _grads(march, vol, rays, cts, algorithm, scheme, substeps=None):
    fld = vol.field.detach().clone().requires_grad_(True)
    rr = [r.detach().clone().requires_grad_(True) for r in rays]
    outs = march(vol._replace(field=fld), *rr, algorithm=algorithm,
                 interpolation_scheme=scheme, substeps=substeps)
    g = torch.autograd.grad(outs, [fld] + rr, grad_outputs=cts)
    return g[0], torch.stack(g[1:])


@pytest.mark.parametrize("algorithm,substeps,scheme", [
    (2, None, 1), (1, None, 1), (3, 2, 1), (2, None, 2), (3, 2, 2)])
def test_march_kernel_matches_the_plain_march(algorithm, substeps, scheme):
    """K1 against the plain march: positions to 5e-6 of the volume's largest
    coordinate and directions to 5e-6 (chip_smoke's K1_TOL).  The same rays
    shuffled give each ray the same bits (two rays share a thread under the
    trilinear scheme, so a ray's neighbour must not move it), and the
    gradient route's head gives the plain head's bits.  The scene's rays
    come in bunches and scattered, some start inside or below the volume or
    travel up, and their count is no multiple of 64."""
    dev = _card()
    vol, rays, _ = _march_scene(dev, p=3001)
    g = march_geometry(vol)
    scale = max(abs(float(v)) for v in (g.min_x, g.min_y, g.z_min, g.z_max))
    kw = dict(algorithm=algorithm, substeps=substeps,
              interpolation_scheme=scheme)
    got = torch.stack(march_chief_fused(vol, *rays, **kw))
    ref = torch.stack(march_chief_dense(vol, *rays, **kw))
    assert bool(torch.isfinite(got).all())
    assert float((got[:3] - ref[:3]).abs().max()) / scale <= 5e-6
    assert float((got[3:] - ref[3:]).abs().max()) <= 5e-6
    perm = torch.randperm(rays[0].shape[0], device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    shuffled = torch.stack(march_chief_fused(
        vol, *(r[perm].contiguous() for r in rays), **kw))
    assert torch.equal(shuffled, got[:, perm])
    if substeps is None:
        field = vol.field if scheme == 1 else bspline_prefilter(vol.field)
        out, _, _ = march_forward_residual(
            field, torch.stack(rays).contiguous(),
            np.asarray(g, dtype=np.float32), algorithm, True, scheme)
        assert torch.equal(out, got)


_STAGEWISE = [(3, 2, 1, None), (3, 3, 1, None), (4, 1, 1, None),
              (3, 2, 2, None), (3, 3, 2, None), (4, 1, 2, None),
              (4, 1, 1, 260)]


@pytest.mark.parametrize("algorithm,substeps,scheme,nxy", _STAGEWISE)
def test_stagewise_march_kernel_matches_the_plain_march(algorithm, substeps,
                                                        scheme, nxy):
    """The stagewise forward (Adams-Bashforth, RK4 with substeps) against
    the plain march at K1's limits (positions to 5e-6 of the volume's
    largest coordinate, directions to 5e-6), on the 12^3 scene and on a
    260 x 260 x 12 one (a slab over 256 x 256); the head that saves the
    residual gives the other head's bits, and shuffled rays their own (the
    large slab's density is smooth: _march_scene)."""
    dev = _card()
    vol, rays, _ = _march_scene(dev, p=3001, nxy=nxy)
    g = march_geometry(vol)
    scale = max(abs(float(v)) for v in (g.min_x, g.min_y, g.z_min, g.z_max))
    field = bspline_prefilter(vol.field) if scheme == 2 else vol.field
    geom = np.asarray(g, dtype=np.float32)
    got, _, _ = march_forward_stagewise(field, rays, geom, algorithm,
                                        substeps, scheme)
    ref = torch.stack(march_chief_dense(
        vol, *rays, algorithm=algorithm, substeps=substeps,
        interpolation_scheme=scheme))
    assert bool(torch.isfinite(got).all())
    assert float((got[:3] - ref[:3]).abs().max()) / scale <= 5e-6
    assert float((got[3:] - ref[3:]).abs().max()) <= 5e-6
    with_res, texit, traj = march_forward_stagewise(
        field, rays, geom, algorithm, substeps, scheme, save_residual=True)
    assert torch.equal(with_res, got)
    assert traj.shape == (field.shape[0] - 1, 5, rays[0].shape[0])
    perm = torch.randperm(rays[0].shape[0], device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    shuffled, _, _ = march_forward_stagewise(
        field, [r[perm].contiguous() for r in rays], geom, algorithm,
        substeps, scheme)
    assert torch.equal(shuffled, got[:, perm])


@pytest.mark.parametrize("algorithm,substeps,scheme,nxy", _STAGEWISE)
def test_stagewise_backward_kernel_matches_autograd(algorithm, substeps,
                                                    scheme, nxy):
    """The stagewise backward against autograd through the plain march:
    d_field to 5e-4 of its maximum and the rays' cotangents to 1e-3 of
    theirs, the limits of the backward kernels K4 and K5.  One launch each
    way and no sampler launch."""
    dev = _card()
    from photon_tpu_torch.ops import march_dense_fused as mdf
    from photon_tpu_torch.ops import march_dense_sampler as mds
    vol, rays, cts = _march_scene(dev, nxy=nxy)
    ref_f, ref_r = _grads(march_chief_dense, vol, rays, cts, algorithm,
                          scheme, substeps)
    fin = torch.isfinite(ref_r)
    wrappers = (mdf.march_forward_stagewise, mdf.march_backward_stagewise,
                mds.slab_sample_forward, mds.slab_sample_backward)
    before = [w.launches for w in wrappers]
    d_f, d_r = _grads(march_chief_fused, vol, rays, cts, algorithm, scheme,
                      substeps)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 0, 0]
    assert _nerr(d_f, ref_f) <= 5e-4
    assert max(_nerr(a[f], b[f]) for a, b, f in zip(d_r, ref_r, fin)
               if bool(f.any())) <= 1e-3


@pytest.mark.parametrize("lens_model", ["general", "thin-lens", "apparent"])
@pytest.mark.parametrize("with_deltas", [True, False])
def test_fan_kernel_matches_the_plain_fan(lens_model, with_deltas):
    """K2 against the plain fan: A, AX, AY to 1e-5 of each column's maximum
    and the centroids AX / A, AY / A to 1e-3 px (chip_smoke's K2_TOL and
    centroid limit); the same bits from run to run."""
    dev = _card()
    sc, cols, deltas, x_lens, y_lens = fan_inputs(lens_model, p=1000, r=500)
    t = [torch.tensor(a, device=dev) for a in cols + deltas]
    d6 = tuple(t[4:]) if with_deltas else None
    xl, yl = torch.tensor(x_lens, device=dev), torch.tensor(y_lens,
                                                            device=dev)
    kw = dict(sc=sc, lens_model=lens_model)
    got = torch.stack(fan_stats(*t[:4], d6, xl, yl, **kw))
    ref = torch.stack(fan_stats_plain(*t[:4], d6, xl, yl, **kw))
    assert max(_nerr(a, b) for a, b in zip(got, ref)) <= 1e-5
    on = ref[0] > 0
    assert int(on.sum()) > 0 and bool((got[0][~on] == 0).all())
    cen = max(float((got[i][on] / got[0][on] - ref[i][on] / ref[0][on])
                    .abs().max()) for i in (1, 2))
    assert cen <= 1e-3
    assert torch.equal(torch.stack(fan_stats(*t[:4], d6, xl, yl, **kw)), got)


@pytest.mark.parametrize("algorithm,scheme", [(2, 1), (1, 1), (2, 2)])
def test_march_backward_kernels_match_autograd(algorithm, scheme,
                                               monkeypatch):
    """K4 (the default budget) and K5 (budget 0) against autograd through
    the plain march: d_field to 5e-4 of its maximum and the rays' cotangents
    to 1e-3 of theirs, the limits of the JAX package's own fused-march
    tests."""
    dev = _card()
    from photon_tpu_torch.ops import march_dense_fused as mdf
    vol, rays, cts = _march_scene(dev)
    ref_f, ref_r = _grads(march_chief_dense, vol, rays, cts, algorithm,
                          scheme)
    fin = torch.isfinite(ref_r)
    before = (mdf.march_backward_stage.launches,
              mdf.march_backward_remarch.launches)
    k4 = _grads(march_chief_fused, vol, rays, cts, algorithm, scheme)
    monkeypatch.setattr(mdf, "TRAJ_MAX_BYTES", 0)
    k5 = _grads(march_chief_fused, vol, rays, cts, algorithm, scheme)
    assert (mdf.march_backward_stage.launches - before[0],
            mdf.march_backward_remarch.launches - before[1]) == (1, 1)
    for d_f, d_r in (k4, k5):
        assert _nerr(d_f, ref_f) <= 5e-4
        assert max(_nerr(a[f], b[f]) for a, b, f in zip(d_r, ref_r, fin)
                   if bool(f.any())) <= 1e-3


@pytest.mark.parametrize("budget", ["stage", "remarch"])
def test_cubic_gradient_march_in_block_order_keeps_each_rays_bits(
        budget, monkeypatch):
    """The cubic scheme's gradient route marches the rays in
    ``block_ray_order``: its outputs and the rays' cotangents are those of
    the same kernels in the caller's order bit for bit, and the field's
    cotangent differs by the order of its float atomics alone, under K4
    and under K5 (budget 0): within 1e-5 of its maximum (K4 read 1.15e-6
    on an H100; two runs in one order differ by ~5e-7, and a cotangent
    taken in the wrong order moves it by its own size)."""
    dev = _card()
    from photon_tpu_torch.ops import march_dense_fused as mdf
    if budget == "remarch":
        monkeypatch.setattr(mdf, "TRAJ_MAX_BYTES", 0)
    vol, rays, cts = _march_scene(dev)
    g = march_geometry(vol)
    geom = np.asarray(g, dtype=np.float32)
    coef = bspline_prefilter(vol.field)
    stacked = torch.stack(rays)
    order = mdf.block_ray_order(stacked, g)
    assert not torch.equal(order, torch.arange(order.shape[0], device=dev))
    save = budget == "stage"
    iters = 0 if save else mdf.defect_iterations(
        g, mdf.remarch_contraction(coef, g))
    got = []
    for o in (order, None):
        fld = coef.detach().clone().requires_grad_(True)
        rr = stacked.detach().clone().requires_grad_(True)
        out = mdf._March.apply(fld, rr, geom, 2, 2, save, iters, o)
        d_f, d_r = torch.autograd.grad(out, [fld, rr],
                                       grad_outputs=torch.stack(cts))
        got.append((out, d_f, d_r))
    (out_a, df_a, dr_a), (out_b, df_b, dr_b) = got
    assert torch.equal(out_a, out_b)
    assert torch.equal(dr_a, dr_b)
    assert _nerr(df_a, df_b) <= 1e-5


@pytest.mark.parametrize("lens_model", ["general", "thin-lens", "apparent"])
@pytest.mark.parametrize("with_deltas", [True, False])
def test_fan_backward_kernel_matches_autograd(lens_model, with_deltas):
    """K6 against autograd through the plain fan, for a centroid loss (each
    particle's AX / A and AY / A, and A): each column's cotangent to 1e-3 of
    its maximum; particles off the sensor get exactly zero.  The centroid
    loss is the hard case: ct_A + ct_AX X + ct_AY Y nearly cancels for every
    ray, so the kernel's X and Y must be the plain version's to the last
    bit."""
    dev = _card()
    p = 300
    sc, cols, deltas, x_lens, y_lens = fan_inputs(lens_model, p=p, r=200)
    gen = torch.Generator(device=dev).manual_seed(7)
    coef = torch.randn(3, p, generator=gen, device=dev)
    xl = torch.tensor(x_lens, device=dev)
    yl = torch.tensor(y_lens, device=dev)
    got, ref = [], []
    for fn, out in ((fan_stats, got), (fan_stats_plain, ref)):
        leaves = [torch.tensor(a, device=dev).requires_grad_(True)
                  for a in cols + (deltas if with_deltas else [])]
        d6 = tuple(leaves[4:]) if with_deltas else None
        fa, fax, fay = fn(*leaves[:4], d6, xl, yl, sc=sc,
                          lens_model=lens_model)
        den = fa.clamp_min(1e-30)
        loss = (coef[0] * fa / float(fa.detach().max()) + coef[1] * fax / den
                + coef[2] * fay / den).sum()
        out.extend(torch.autograd.grad(loss, leaves))
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        assert _nerr(g, r) <= 1e-3
    off = ref[0] == 0
    assert int(off.sum()) > 0
    assert all(bool((g[off] == 0).all()) for g in got)


@pytest.mark.parametrize("scheme", [1, 2])
def test_sampler_backward_kernel_matches_autograd(scheme):
    """K9 against autograd through the plain sampler: the slabs' cotangent
    to 5e-5 of its maximum, the coordinates' to 5e-6 of each row's (noise
    slabs, coordinates beyond both clamps, rays in bunches)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    h, w, p = 40, 56, 5000
    lo, hi = (torch.randn(h, w, 4, generator=gen, device=dev)
              for _ in range(2))
    centre = (torch.rand(p // 50, 2, generator=gen, device=dev)
              * torch.tensor([w + 5.0, h + 5.0], device=dev) - 3.0)
    u = centre.repeat_interleave(50, 0) + 0.05 * torch.rand(
        p, 2, generator=gen, device=dev)
    ux, uy = u[:, 0].contiguous(), u[:, 1].contiguous()
    uz = torch.rand(p, generator=gen, device=dev)
    ct = torch.randn(4, p, generator=gen, device=dev)
    d_lo, d_hi, d_u = slab_sample_backward(lo, hi, ux, uy, uz, ct, scheme)
    leaves = [t.clone().requires_grad_(True) for t in (lo, hi, ux, uy, uz)]
    ref = torch.autograd.grad(torch.stack(slab_sample_plain(*leaves, scheme)),
                              leaves, grad_outputs=ct)
    assert max(_nerr(d_lo, ref[0]), _nerr(d_hi, ref[1])) <= 5e-5
    assert max(_nerr(a, b) for a, b in zip(d_u, ref[2:])) <= 5e-6


def _splat_spots(dev, layout, P, K, nx=512, ny=384, seed=7):
    """P spots: dots of 120 consecutive particles ("dots": within a pixel
    or two, as the bench's; "wide dots": spread over 24 px) or uniform over
    the frame ("scattered"); 5% with zero amplitude, every 97th the
    renderer's sentinel."""
    rng = np.random.default_rng(seed)
    if layout == "scattered":
        X = rng.uniform(-0.5, nx - 0.5, P)
        Y = rng.uniform(-0.5, ny - 0.5, P)
    else:
        spread = 0.8 if layout == "dots" else 12.0
        dots = rng.uniform([8, 8], [nx - 8, ny - 8], (-(-P // 120), 2))
        d = np.repeat(np.arange(len(dots)), 120)[:P]
        X = dots[d, 0] + rng.normal(0, spread, P)
        Y = dots[d, 1] + rng.normal(0, spread, P)
    A = rng.uniform(0.1, 2.0, P) * np.pi / 32.0
    A[rng.random(P) < 0.05] = 0.0
    A[::97] = 0.0
    X[::97] = -1e6
    X, Y, A = (torch.tensor(v, dtype=torch.float32, device=dev)
               for v in (X, Y, A))
    col0 = (torch.round(X).to(torch.int32) - K // 2).clamp(0, nx - K)
    row0 = (torch.round(Y).to(torch.int32) - K // 2).clamp(0, ny - K)
    return [X, Y, A, col0, row0], dict(K=K, ny=ny, nx=nx)


# the kernels give a warp 1, 2, 8, 16 and 32 particles at these P
# (particles_a_warp in csrc/splat.cu, K = 8 and 12)
_SPLAT_CASES = [(layout, P) for layout in ("dots", "wide dots", "scattered")
                for P in (2000, 5000, 20000, 40000, 72000)]


@pytest.mark.parametrize("layout,P", _SPLAT_CASES)
def test_splat_kernel_matches_the_plain_splat(layout, P):
    """K3 against the plain splat to 1e-5 of the image maximum (chip_smoke's
    K3_TOL): the same erff of edges that may round an ulp apart, and float
    atomics in a changing order."""
    dev = _card()
    for K, D in ((8, 3.3), (12, 5.0)):
        args, kw = _splat_spots(dev, layout, P, K)
        kw.update(diameter=D, render_fraction=0.75)
        got = splat_particles(*args, **kw)
        ref = splat_particles_plain(*args, **kw)
        assert float(ref.max()) > 0
        assert float((got - ref).abs().max() / ref.max()) <= 1e-5


@pytest.mark.parametrize("layout,P", _SPLAT_CASES)
def test_splat_transpose_kernel_matches_autograd(layout, P):
    """K7 against autograd through the plain splat, to 1e-5 of each output's
    maximum (chip_smoke's K7_TOL); no atomics, so two launches are equal."""
    dev = _card()
    args, kw = _splat_spots(dev, layout, P, 8)
    kw.update(diameter=3.3, render_fraction=0.75)
    gen = torch.Generator(device=dev).manual_seed(9)
    ct = torch.randn(kw["ny"], kw["nx"], generator=gen, device=dev)
    leaves = [a.clone().requires_grad_(True) for a in args[:3]]
    img = splat_particles_plain(*leaves, args[3], args[4], **kw)
    ref = torch.autograd.grad(img, leaves, grad_outputs=ct)
    opts = dict(K=8, diameter=3.3, render_fraction=0.75)
    got = splat_backward(*args, ct, **opts)
    assert torch.equal(got, splat_backward(*args, ct, **opts))
    for g, r in zip(got, ref):
        assert _nerr(g, r) <= 1e-5
    off = args[2] == 0
    assert float(got[2][~off].abs().max()) > 0


def test_splat_kernels_large_patch_on_a_small_frame():
    """K = 40 on a 72 x 96 frame, spots on its edges and corners and one of
    zero amplitude: both kernels against the plain versions."""
    dev = _card()
    X = torch.tensor([-0.4, 71.4, 3.0, 36.0, 70.0, 20.0], device=dev)
    Y = torch.tensor([-0.4, 95.4, 95.0, 0.2, 50.0, 40.0], device=dev)
    A = torch.tensor([1.0, 2.0, 0.5, 1.5, 0.0, 0.7], device=dev)
    col0 = (torch.round(X).to(torch.int32) - 20).clamp(0, 72 - 40)
    row0 = (torch.round(Y).to(torch.int32) - 20).clamp(0, 96 - 40)
    kw = dict(K=40, ny=96, nx=72, diameter=20.0, render_fraction=0.75)
    got = splat_particles(X, Y, A, col0, row0, **kw)
    ref = splat_particles_plain(X, Y, A, col0, row0, **kw)
    assert float((got - ref).abs().max() / ref.max()) <= 1e-5
    ct = torch.randn(96, 72, generator=torch.Generator(device=dev)
                     .manual_seed(4), device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (X, Y, A)]
    gref = torch.autograd.grad(
        splat_particles_plain(*leaves, col0, row0, **kw), leaves,
        grad_outputs=ct)
    gk = splat_backward(X, Y, A, col0, row0, ct, K=40, diameter=20.0,
                        render_fraction=0.75)
    assert max(_nerr(g, r) for g, r in zip(gk, gref)) <= 1e-5


def _gradient_input(rng, shape):
    return torch.from_numpy((0.225e-3 * (1.2 + 0.8 * rng.random(shape)))
                            .astype(np.float32))


@pytest.mark.parametrize("shape", native.GRADIENT_EDGE_SHAPES)
def test_gradient_field_kernel_is_the_plain_stencil_bit_for_bit(shape):
    """K10 against the plain float64 stencil on the CPU: every value equal
    (both widen float32 n-1 to double and round once; the library is built
    without contraction), on shapes that reach every edge of its tiles."""
    dev = _card()
    rng = np.random.default_rng(sum(shape))
    nm1 = _gradient_input(rng, shape)
    spacing = (100.0, 110.0, 120.0)
    got = native.gradient_field(nm1.to(dev), spacing)
    torch.cuda.synchronize(dev)
    assert torch.equal(got.cpu(), native.gradient_field_plain(nm1, spacing))
    # and the density volume, float64 rho, on the card and on the CPU
    rho = 1.2 + 0.8 * rng.random(shape)
    on_card = build_density_volume(rho, spacing, (0, 0, 0), device=dev)
    on_cpu = build_density_volume(rho, spacing, (0, 0, 0), device="cpu")
    assert torch.equal(on_card.field.cpu(), on_cpu.field)


def test_gradient_field_kernel_takes_an_input_off_16_bytes():
    """An input whose first sample lies 4 bytes past a 16-byte boundary (D
    a multiple of 4): K10 copies it a float at a time, bit for bit."""
    dev = _card()
    shape = (33, 6, 68)
    nm1 = _gradient_input(np.random.default_rng(7), shape)
    flat = torch.zeros(1 + nm1.numel(), device=dev)
    flat[1:] = nm1.reshape(-1).to(dev)
    shifted = flat[1:].view(shape)
    assert shifted.data_ptr() % 16 == 4
    got = native.gradient_field(shifted, (100.0, 110.0, 120.0))
    torch.cuda.synchronize(dev)
    assert torch.equal(got.cpu(), native.gradient_field_plain(
        nm1, (100.0, 110.0, 120.0)))


SPACING = (100.0, 110.0, 120.0)
GD = 0.225e-3


def _transpose_input(rng, shape):
    """A float32 (D, H, W, 4) cotangent of the packed field of a (W, H, D)
    grid."""
    w, h, d = shape
    return torch.from_numpy(rng.normal(size=(d, h, w, 4)).astype(np.float32))


@pytest.mark.parametrize("shape", native.GRADIENT_EDGE_SHAPES)
def test_gradient_transpose_kernel_is_the_plain_version_bit_for_bit(shape):
    """K13 against its plain float64 version on the CPU: every value equal
    (both widen float32 to double, sum a voxel's terms in one order and
    round once; the library is built without contraction), on the shapes
    that reach every edge of the tiles and y runs it shares with K10."""
    dev = _card()
    ct = _transpose_input(np.random.default_rng(sum(shape)), shape)
    got = native.gradient_field_transpose(ct.to(dev), SPACING, GD)
    torch.cuda.synchronize(dev)
    assert torch.equal(got.cpu(), native.gradient_field_transpose_plain(
        ct, SPACING, GD))


def test_gradient_transpose_kernel_takes_an_input_off_16_bytes():
    """A cotangent whose first sample lies 4 bytes past a 16-byte boundary:
    K13 copies it a float at a time, bit for bit."""
    dev = _card()
    shape = (33, 6, 68)
    ct = _transpose_input(np.random.default_rng(8), shape)
    flat = torch.zeros(1 + ct.numel(), device=dev)
    flat[1:] = ct.reshape(-1).to(dev)
    shifted = flat[1:].view(ct.shape)
    assert shifted.data_ptr() % 16 == 4
    got = native.launch_gradient_field_transpose(shifted, SPACING, GD)
    torch.cuda.synchronize(dev)
    assert torch.equal(got.cpu(), native.gradient_field_transpose_plain(
        ct, SPACING, GD))


_BAD_TRANSPOSE = {
    "float64": lambda ct: ct.double(),
    "strided": lambda ct: ct.transpose(0, 2),
    "three axes": lambda ct: ct[..., 0],
    "three channels": lambda ct: ct[..., :3].contiguous(),
}


@pytest.mark.parametrize("case", sorted(_BAD_TRANSPOSE))
def test_gradient_transpose_launcher_refuses_what_the_kernel_does_not_take(
        case):
    """A wrong dtype, layout or rank on the card raises before a launch."""
    dev = _card()
    bad = _BAD_TRANSPOSE[case](torch.zeros(6, 5, 4, 4, device=dev))
    before = native.launch_gradient_field_transpose.launches
    with pytest.raises((TypeError, ValueError)):
        native.launch_gradient_field_transpose(bad, SPACING, GD)
    assert native.launch_gradient_field_transpose.launches == before


def test_volume_from_rho_on_the_card_is_k10_forward_and_k13_backward():
    """On the card volume_from_rho's field is native.gradient_field of
    gladstone_dale * rho bit for bit (K10, one launch), and its rho
    gradient (K13, one launch) matches autograd through the float32
    grad_axis on the CPU within 1e-6 of the largest component (the bound
    of tests/test_torch_inverse.py::test_volume_from_rho_gradient_matches_jax)."""
    dev = _card()
    shape = (33, 6, 68)
    rng = np.random.default_rng(12)
    rho = torch.from_numpy((1.2 + 0.8 * rng.random(shape)).astype(np.float32))
    template = build_density_volume(rho.numpy(), SPACING, (0, 0, 0),
                                    device=dev)
    k10, k13 = (native.launch_gradient_field.launches,
                native.launch_gradient_field_transpose.launches)
    r = rho.to(dev).requires_grad_(True)
    field = volume_from_rho(r, template, GD).field
    w = torch.from_numpy(rng.normal(size=field.shape).astype(np.float32))
    (g,) = torch.autograd.grad(field, r, w.to(dev))
    torch.cuda.synchronize(dev)
    assert native.launch_gradient_field.launches == k10 + 1
    assert native.launch_gradient_field_transpose.launches == k13 + 1
    assert torch.equal(field, native.gradient_field(
        GD * rho.to(dev), template.grid_spacing))
    rc = rho.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(
        volume_from_rho(rc, template._replace(field=template.field.cpu()),
                        GD).field, rc, w)
    assert float((g.cpu() - ref).abs().max()) <= 1e-6 * float(
        ref.abs().max())


def test_invert_bos_launches_k10_and_k13_once_a_step():
    """invert_bos on a small grid on the card: K10 once a step (and once
    for the result volume), K13 once a step, by their counters."""
    dev = _card()
    cfg, setup, source, r1, r2, rho, vol = small_bos_scene(device=dev)
    r1, r2 = r1.numpy(), r2.numpy()
    target = render_image_fast(cfg, setup, source, r1, r2, vol=vol,
                               device=dev)
    k10, k13 = (native.launch_gradient_field.launches,
                native.launch_gradient_field_transpose.launches)
    res = invert_bos(cfg, setup, source, r1, r2, target, vol,
                     rho0=0.9 * rho, steps=3, learning_rate=1e-3, device=dev)
    torch.cuda.synchronize(dev)
    assert native.launch_gradient_field.launches == k10 + 3 + 1
    assert native.launch_gradient_field_transpose.launches == k13 + 3
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()


# (D, H, W, C): the bench's channels; ragged tiles (no axis a multiple of a
# tile, C = 3: the copies a float at a time); C = 1 and axes of 3 and 4; a
# line of 8192 samples in a tile of 196,608 bytes (the few lines of axis 0);
# a line of 8192 samples that takes the one-thread-a-line kernel
_PREFILTER_SHAPES = [(16, 18, 20, 4), (67, 45, 129, 3), (5, 3, 4, 1),
                     (8192, 2, 3, 1), (8192, 2, 3, 4)]


def _prefilter_case(dev, shape, seed=9):
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=f.shape).astype(np.float32))
    return f.to(dev), ct.to(dev)


def _prefilter_f64(field):
    """The prefilter's function in float64 on the host, written apart from
    the port's: pole sqrt(3) - 2 unrounded, the causal start over
    min(n, 13) terms, the mirrored anticausal start."""
    z = np.sqrt(3.0) - 2.0
    lam = (1.0 - z) * (1.0 - 1.0 / z)
    out = field.detach().cpu().double().numpy()
    for axis in range(3):
        a = np.moveaxis(out, axis, 0).copy()
        n = a.shape[0]
        start = np.tensordot(z ** np.arange(min(n, 13)), a[:13], axes=1)
        c = lam * a
        c[0] = lam * start
        for i in range(1, n):
            c[i] += z * c[i - 1]
        c[n - 1] = z / (z * z - 1.0) * (z * c[n - 2] + c[n - 1])
        for i in range(n - 2, -1, -1):
            c[i] = z * (c[i + 1] - c[i])
        out = np.moveaxis(c, 0, axis)
    return out


def _routes(shape):
    return [p.tiled for p in native.prefilter_plan(*shape)]


@pytest.mark.parametrize("shape", _PREFILTER_SHAPES)
def test_prefilter_kernel_matches_the_plain_prefilter(shape):
    """K11 against the plain prefilter on the card, bit for bit (the same
    float32 recurrences, the causal start summed in the same order), and
    within 2e-6 of the maximum of a float64 prefilter written apart from
    both (the CPU tests' limit against the JAX package's float64
    prefilters); two launches equal (no atomics).  The last shape's axis 0
    takes the one-thread-a-line kernel, every other axis the tiles."""
    dev = _card()
    assert _routes(shape) == [shape != (8192, 2, 3, 4), True, True]
    f, _ = _prefilter_case(dev, shape)
    got = bspline_prefilter(f)
    assert torch.equal(got, bspline_prefilter_plain(f))
    ref = _prefilter_f64(f)
    assert np.abs(got.cpu().numpy() - ref).max() <= 2e-6 * np.abs(ref).max()
    assert torch.equal(got, bspline_prefilter(f))


@pytest.mark.parametrize("shape", _PREFILTER_SHAPES)
def test_prefilter_transpose_kernel_matches_autograd(shape):
    """K12 against autograd through the plain prefilter, bit for bit, and
    the dot-product identity <K11 x, y> = <x, K12 y> summed in float64
    (relative 1e-6); two launches equal."""
    dev = _card()
    f, ct = _prefilter_case(dev, shape)
    leaf = f.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(bspline_prefilter_plain(leaf), leaf, ct)
    leaf = f.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(bspline_prefilter(leaf), leaf, ct)
    assert torch.equal(got, ref)
    assert torch.equal(got, native.launch_prefilter_bwd(ct))
    lhs = float((bspline_prefilter(f).double() * ct.double()).sum())
    rhs = float((f.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def test_prefilter_kernels_take_a_misaligned_field():
    """A field that starts 4 bytes past a 16-byte boundary (a view of a
    larger buffer): the tiles copy a float at a time, with the same bits."""
    dev = _card()
    f, ct = _prefilter_case(dev, (16, 18, 20, 4))
    buf = torch.empty(f.numel() + 1, device=dev)
    buf[1:] = f.reshape(-1)
    g = buf[1:].view(f.shape)
    assert g.data_ptr() % 16 == 4
    assert torch.equal(native.launch_prefilter(g), bspline_prefilter_plain(f))
    buf[1:] = ct.reshape(-1)
    assert torch.equal(native.launch_prefilter_bwd(g),
                       native.launch_prefilter_bwd(ct))


def test_prefilter_counters_count_kernel_launches():
    """One call of K11 raises ``launch_prefilter.launches`` by three and one
    of K12 ``launch_prefilter_bwd.launches`` by three: a launch an axis, so
    that a trace's launches can be held to the counters."""
    dev = _card()
    f, ct = _prefilter_case(dev, (16, 18, 20, 4))
    leaf = f.clone().requires_grad_(True)
    k11, k12 = (native.launch_prefilter.launches,
                native.launch_prefilter_bwd.launches)
    out = bspline_prefilter(leaf)
    assert native.launch_prefilter.launches == k11 + 3
    assert native.launch_prefilter_bwd.launches == k12
    torch.autograd.grad(out, leaf, ct)
    torch.cuda.synchronize(dev)
    assert native.launch_prefilter.launches == k11 + 3
    assert native.launch_prefilter_bwd.launches == k12 + 3


def test_invert_bos_takes_the_configs_cubic_scheme():
    """invert_bos with a config that asks for the cubic scheme runs K11
    and K12 once a step each (three launches a call), and none under the
    trilinear one."""
    import dataclasses
    dev = _card()
    cfg, setup, source, r1, r2, rho, vol = small_bos_scene(device=dev)
    r1, r2 = r1.numpy(), r2.numpy()
    cubic = dataclasses.replace(cfg, density_gradients=dataclasses.replace(
        cfg.density_gradients, interpolation_scheme=2))
    target = render_image_fast(cfg, setup, source, r1, r2, vol=vol,
                               interpolation_scheme=2, device=dev)
    for c, per_step in ((cubic, 3), (cfg, 0)):
        k11, k12 = (native.launch_prefilter.launches,
                    native.launch_prefilter_bwd.launches)
        res = invert_bos(c, setup, source, r1, r2, target, vol,
                         rho0=0.9 * rho, steps=2, learning_rate=1e-3,
                         device=dev)
        torch.cuda.synchronize(dev)
        assert native.launch_prefilter.launches == k11 + 2 * per_step
        assert native.launch_prefilter_bwd.launches == k12 + 2 * per_step
        assert len(res.losses) == 2 and np.isfinite(res.losses).all()


def test_cubic_weights_on_the_card_are_the_cpus():
    """The exact path's cubic B-spline weights (ops/interp.py) divide by 6
    as on the CPU: a Python divisor would be its rounded reciprocal on the
    card, and a third of the weights one ulp off."""
    dev = _card()
    t = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0))
    got = torch.stack(interp._bspline_weights(t.to(dev))).cpu()
    assert torch.equal(got, torch.stack(interp._bspline_weights(t)))


def _exact_scene(n_rays=1024, n=32, seed=11):
    """A 32^3 ramp with a Gaussian bump (the cubic weights' fractions vary
    from sample to sample) and rays from above it, slightly tilted."""
    extent, depth = 3e5, 1e5
    x = np.linspace(-extent / 2, extent / 2, n)
    z = np.linspace(0.0, depth, n)
    X, Y, Z = np.meshgrid(x, x, z, indexing="ij")
    rho = (1.225 + 5.0 * (X - x[0]) / extent
           + 2.0 * np.exp(-((X - 2e4) ** 2 + Y ** 2 + (Z - 5e4) ** 2)
                          / (2 * 4e4 ** 2)))
    vol = build_density_volume(rho, [x[1] - x[0], x[1] - x[0], z[1] - z[0]],
                               [x[0], x[0], 0.0], device="cpu")
    rng = np.random.default_rng(seed)
    d = np.stack([rng.uniform(-0.02, 0.02, n_rays),
                  rng.uniform(-0.02, 0.02, n_rays), -np.ones(n_rays)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = np.stack([rng.uniform(-5e4, 5e4, n_rays),
                    rng.uniform(-5e4, 5e4, n_rays),
                    np.full(n_rays, depth + 1e4)], -1)
    rays = RayBundle(*(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                       for a in (pos, d, np.zeros(n_rays),
                                 np.ones(n_rays))))
    return vol, rays


@pytest.mark.parametrize("scheme", [1, 2])
def test_exact_march_on_the_card_is_the_cpus(scheme):
    """The exact path's RK4 march (ops/march.py) on the card and on the CPU
    on the same rays: every exit state equal bit for bit, under both
    schemes (the coefficients are K11's on the card, the plain prefilter's
    on the CPU, equal bit for bit)."""
    dev = _card()
    vol, rays = _exact_scene()
    on_cpu = exact_march.march_rays(vol, rays, algorithm=2,
                                    interpolation_scheme=scheme)
    on_card = exact_march.march_rays(
        vol._replace(field=vol.field.to(dev)),
        RayBundle(*(a.to(dev) for a in rays)), algorithm=2,
        interpolation_scheme=scheme)
    moved = (on_cpu.pos != rays.pos).any(-1)
    assert int(moved.sum()) > len(moved) // 2
    assert torch.equal(on_card.pos.cpu(), on_cpu.pos)
    assert torch.equal(on_card.dir.cpu(), on_cpu.dir)
