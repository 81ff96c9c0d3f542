"""The port's kernels against their plain versions on the card, at a small
size: the march (K1, both heads, both schemes, two rays a thread under the
trilinear one) against the plain march, rays in input order and shuffled;
the fan statistics (K2) against the plain fan, three lens models; the
march's stage and re-march backward (K4, K5) against autograd through the
plain march, both schemes, rays in bunches that share voxels (the merged
scatter) and scattered rays (the direct one); the fan's backward (K6)
against autograd through the plain fan, three lens models; the sampler's
backward (K9), which shares K4's scatter; the splat (K3) against the plain
splat and its transpose (K7) against autograd through it, on spots in runs
of 120 that share a dot (the bench's order; runs of the kernel straddle two
dots), dots spread over 24 px, scattered spots and zero-amplitude
particles, in launches that give a warp 1, 2, 8, 16 and 32 particles, and
a K = 40 patch on a small frame.

Each test skips without a CUDA device.  This file imports no jax, so it runs
where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from photon_tpu_torch.ops.fan import fan_stats, fan_stats_plain
from photon_tpu_torch.ops.march_dense import (bspline_prefilter,
                                              march_chief_dense,
                                              march_geometry)
from photon_tpu_torch.ops.march_dense_fused import (march_chief_fused,
                                                    march_forward_residual)
from photon_tpu_torch.ops.march_dense_sampler import (slab_sample_backward,
                                                      slab_sample_plain)
from photon_tpu_torch.ops.splat import (splat_backward, splat_particles,
                                        splat_particles_plain)
from photon_tpu_torch.volume import build_density_volume
from torch_port_helpers import fan_inputs

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _nerr(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _march_scene(dev, p=3000, n=12, seed=3):
    """A random 12^3 volume; rays in bunches of 40 that share their voxels
    (the source points of a dot), then scattered ones, some starting inside
    or below the volume or travelling up; p is no multiple of 32."""
    rng = np.random.default_rng(seed)
    rx = np.linspace(-6e4, 6e4, n)
    rz = np.linspace(4.0e5, 9.0e5, n)
    vol = build_density_volume(
        1.2 + 0.8 * rng.random((n, n, n)), [rx[1] - rx[0]] * 2
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


def _grads(march, vol, rays, cts, algorithm, scheme):
    fld = vol.field.detach().clone().requires_grad_(True)
    rr = [r.detach().clone().requires_grad_(True) for r in rays]
    outs = march(vol._replace(field=fld), *rr, algorithm=algorithm,
                 interpolation_scheme=scheme)
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
