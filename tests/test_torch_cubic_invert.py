"""The cubic B-spline inversion (``interpolation_scheme`` 2) on the CPU:
``invert_bos`` takes the configuration's scheme and follows the plain
reference of ``benchmark/reference/cubic.py`` (its own prefilter, sample,
march and backward, written apart from the port's) step for step; the
reference's prefilter and sample interpolate; its march backward is
autograd through its own forward; the cubic march's touched coefficients
are counted as a brute force counts them; on the card's route the
prefilter's two kernels run inside their spans; the order in which the
card's cubic gradient march takes the rays sorts each block of them by
where it crosses the volume and keeps the blocks in place."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.counts.march_bwd_cubic import touched_coefficients
from benchmark.reference import cubic as C
from benchmark.reference import render as R
from photon_tpu_torch import native
from photon_tpu_torch.inverse import invert_bos
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.volume import build_density_volume
from tests.torch_port_helpers import small_bos_scene

N = 12
STEPS = 3
# invert_bos against the reference, relative.  The two sides differ in
# float32 rounding alone: the prefilter (float32 recursions over 12 causal
# terms against float64 with the exact mirror start), the weights' formulas
# and the order of the 16 taps' sums.  LOSS_TOL: the loss is the mean
# square of a small image difference, so the render's rounding gap (~1e-5
# of the image) reads ~1e-4 there (9.0e-5 on this scene).  CHANGE_TOL: the
# norm of rho's change after the steps; Adam moves a voxel whose gradient
# is near its eps (1e-12) by a share of the rate that rounding sets, and on
# 12-voxel axes the prefilter transpose's tails put many voxels there
# (1.6e-3 on this scene, 6.7e-3 at ten times the rate).  The trilinear
# solve of the scene reads 0.30 and 0.99.
LOSS_TOL = 5e-4
CHANGE_TOL = 1e-2


def _with_scheme(cfg, scheme):
    return dataclasses.replace(cfg, density_gradients=dataclasses.replace(
        cfg.density_gradients, interpolation_scheme=scheme))


@pytest.fixture(scope="module")
def scene():
    """The small BOS scene of the port's tests on a 12^3 grid, with a
    Gaussian density centred where its chief rays cross (a ramp would be
    sampled alike by both schemes), 24 particles of 8 rays."""
    cfg, setup, source, r1, r2, _, _ = small_bos_scene(n=N)
    x = np.linspace(-2e5, 2e5, N)
    z = np.linspace(setup.object_distance * 0.4,
                    setup.object_distance * 0.9, N)
    spacing = [x[1] - x[0], x[1] - x[0], z[1] - z[0]]
    origin = [x[0], x[0], z[0]]
    gx = np.exp(-(x / 9e4) ** 2 / 2.0)
    gz = np.exp(-((z - z.mean()) / (0.2 * np.ptp(z))) ** 2 / 2.0)
    rho = (1.225 + 3.0 * gx[:, None, None] * gx[None, :, None]
           * gz[None, None, :]).astype(np.float32)
    vol = build_density_volume(rho, spacing, origin, device="cpu")
    return dict(cfg=_with_scheme(cfg, 2), setup=setup, source=source,
                r1=r1.numpy(), r2=r2.numpy(), rho=torch.from_numpy(rho),
                vol=vol, spacing=spacing, origin=origin)


def _program(s, cfg):
    """invert_bos's losses and rho's change, on the observation rendered
    under the configuration's scheme."""
    target = render_image_fast(
        cfg, s["setup"], s["source"], s["r1"], s["r2"], vol=s["vol"],
        interpolation_scheme=int(cfg.density_gradients.interpolation_scheme),
        device="cpu")
    rho0 = 0.8 * s["rho"]
    span = float(s["rho"].max() - s["rho"].min())
    res = invert_bos(cfg, s["setup"], s["source"], s["r1"], s["r2"],
                     target, s["vol"], rho0=rho0.numpy(), steps=STEPS,
                     learning_rate=1e-4 * span, device="cpu")
    return res.losses, torch.from_numpy(res.rho) - rho0


def _reference(s):
    cfg = s["cfg"]
    gd = float(cfg.density_gradients.gladstone_dale)
    sc = R.scene(cfg, s["setup"], s["source"], torch.from_numpy(s["r1"]),
                 torch.from_numpy(s["r2"]), torch.device("cpu"))
    g = R.geometry((N, N, N), s["spacing"], s["origin"],
                   float(s["vol"].data_min))
    target = C.render(sc, R.gradient_field(gd * s["rho"], s["spacing"]), g)
    sp = [float(v) for v in s["vol"].grid_spacing]
    rho0 = 0.8 * s["rho"]
    span = float(s["rho"].max() - s["rho"].min())
    losses, rhos, _ = C.invert_steps_cubic(sc, g, sp, gd, rho0, target,
                                        1e-4 * span, STEPS)
    return losses, rhos[-1] - rho0


def _gaps(a, b):
    (la, ca), (lb, cb) = a, b
    loss = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
    change = float((ca - cb).norm() / cb.norm())
    return loss, change


@pytest.fixture(scope="module")
def runs(scene):
    return dict(cubic=_program(scene, scene["cfg"]),
                trilinear=_program(scene, _with_scheme(scene["cfg"], 1)),
                reference=_reference(scene))


def test_invert_bos_under_the_cubic_scheme_matches_the_reference(runs):
    loss, change = _gaps(runs["cubic"], runs["reference"])
    assert loss <= LOSS_TOL and change <= CHANGE_TOL, (loss, change)
    assert all(np.isfinite(runs["cubic"][0]))
    assert float(runs["cubic"][1].norm()) > 0


def test_the_configs_scheme_reaches_the_march(runs):
    """The trilinear solve of the same scene is ten times the tolerances
    from the cubic reference: the configuration's scheme is the one
    marched."""
    loss, change = _gaps(runs["trilinear"], runs["reference"])
    assert loss > 10 * LOSS_TOL and change > 10 * CHANGE_TOL, (loss, change)


def test_reference_prefilter_and_sample_interpolate():
    """In float64: the sample at the inner nodes of a field constant along
    z returns its samples, and inside the grid (where the mirror start's
    reach has decayed) it reproduces a cubic polynomial in x and y."""
    d, h, w = 4, 48, 52
    y = torch.arange(h, dtype=torch.float64)[:, None]
    x = torch.arange(w, dtype=torch.float64)[None, :]

    def poly(x, y):
        return 0.02 * x ** 3 - 0.3 * x * x * y + 0.01 * y ** 3 + x - 2.0

    field = poly(x, y)[None, :, :, None].expand(d, h, w, 4).contiguous()
    coeffs = C._prefilter64(field)
    uy, ux = torch.meshgrid(torch.arange(1.0, h - 1, dtype=torch.float64),
                            torch.arange(1.0, w - 1, dtype=torch.float64),
                            indexing="ij")
    ux, uy = ux.reshape(-1), uy.reshape(-1)
    uz = torch.full_like(ux, 0.3)
    got, _ = C.slab_sample(coeffs[1], coeffs[2], ux, uy, uz)
    want = field[1, 1:h - 1, 1:w - 1].reshape(-1, 4)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())
    gen = torch.Generator().manual_seed(5)
    ux = 22.0 + 8.0 * torch.rand(64, generator=gen, dtype=torch.float64)
    uy = 20.0 + 8.0 * torch.rand(64, generator=gen, dtype=torch.float64)
    got, _ = C.slab_sample(coeffs[1], coeffs[2], ux, uy,
                           torch.full_like(ux, 0.5))
    want = poly(ux, uy)
    assert float((got[:, 0] - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


def test_reference_prefilter_against_the_ports_plain_version():
    """The reference's float64 prefilter, rounded, against the port's
    float32 one on a 24^3 field: float32 rounding apart (the causal starts
    differ by terms of z^12 and below)."""
    gen = torch.Generator().manual_seed(6)
    f = torch.rand((24, 24, 24, 4), generator=gen) - 0.5
    got, want = C.prefilter(f), native.bspline_prefilter_plain(f)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


def _rays(g, P, gen):
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(P, generator=gen)  # noqa
    tx, ty = u(-0.02, 0.02), u(-0.02, 0.02)
    inv = torch.rsqrt(tx * tx + ty * ty + 1.0)
    return [g.min_x + g.sx * u(1.0, g.w - 3.0),
            g.min_y + g.sy * u(1.0, g.h - 3.0),
            torch.full((P,), g.z_max + 3.0), tx * inv, ty * inv, -inv]


def test_reference_march_backward_is_autograd_through_its_march():
    gen = torch.Generator().manual_seed(3)
    g = R.geometry((12, 10, 9), [2.0, 3.0, 5.0], [0.0, 0.0, 750e3 - 50.0],
                   1e-3)
    coeffs = (torch.rand((9, 10, 12, 4), generator=gen) - 0.5) * 2e-3
    rays = _rays(g, 64, gen)
    ct = [torch.randn(64, generator=gen) for _ in range(6)]
    ct[0] = torch.zeros(64)
    _, tape = C.march_deltas(coeffs, g, rays, keep=True)
    got = C.march_backward(coeffs, g, rays, tape, tuple(ct))
    leaf = coeffs.clone().requires_grad_(True)
    S, z, inside = C.march_all(leaf, g, rays)
    (want,) = torch.autograd.grad(R._exit_deltas(S, z, inside, rays)[1:],
                                  leaf, grad_outputs=ct[1:])
    assert torch.allclose(got, want, rtol=1e-4,
                          atol=1e-6 * float(want.abs().max()))
    assert float(want.abs().max()) > 0


def test_reference_prefilter_transpose_is_its_adjoint():
    gen = torch.Generator().manual_seed(7)
    f = torch.rand((7, 9, 11, 4), generator=gen, dtype=torch.float64)
    ct = torch.rand((7, 9, 11, 4), generator=gen, dtype=torch.float32)
    lhs = float((C._prefilter64(f) * ct.double()).sum())
    rhs = float((f * C.prefilter_transpose(ct).double()).sum())
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def _touched_brute(g, rays):
    """Every tap of every cubic sample, one at a time, in a set."""
    x0, y0, z0, cx, cy, cz = (t.tolist() for t in rays)
    planes = g.z_planes()
    out = set()
    for p in range(len(x0)):
        if cz[p] >= 0:
            continue
        z_in = min(z0[p], g.z_max)
        if z_in < g.z_min:
            continue
        for s, zb in enumerate(planes):
            zt = min(g.z_max if s == 0 else planes[s - 1], z_in)
            if not zt > zb:
                continue
            ks = g.d - 2 - s
            for frac in (0.0, 0.5, 1.0):
                t = (zt + frac * (zb - zt) - z0[p]) / cz[p]
                ux = 0.5 + (x0[p] + cx[p] * t - g.min_x) / g.sx
                uy = 0.5 + (y0[p] + cy[p] * t - g.min_y) / g.sy
                ix = int(np.floor(min(max(ux, -2.0), g.w + 1.0)))
                iy = int(np.floor(min(max(uy, -2.0), g.h + 1.0)))
                for j in range(iy - 1, iy + 3):
                    for i in range(ix - 1, ix + 3):
                        flat = (min(max(j, 0), g.h - 1) * g.w
                                + min(max(i, 0), g.w - 1))
                        out.add((ks, flat))
                        out.add((ks + 1, flat))
    return len(out)


def test_cubic_touched_coefficients_against_a_brute_force_count():
    gen = torch.Generator().manual_seed(8)
    g = R.geometry((9, 8, 7), [1.0, 1.5, 2.0], [0.0, 0.0, 750e3 - 14.0],
                   0.0)
    rays = _rays(g, 12, gen)
    # one ray from inside the volume, one upward, one along an edge
    rays[2][3] = g.z_max - 3.0
    rays[5][4] = -rays[5][4]
    rays[0][5] = g.min_x
    want = _touched_brute(g, rays)
    assert want > 0 and touched_coefficients(g, rays) == want
    # a vertical ray keeps one 4 x 4 footprint through all seven planes
    one = [torch.tensor([4.2]), torch.tensor([5.1]),
           torch.tensor([g.z_max + 5.0]), torch.tensor([0.0]),
           torch.tensor([0.0]), torch.tensor([-1.0])]
    assert touched_coefficients(g, one) == 16 * 7


class _Reached(Exception):
    pass


def test_prefilter_kernels_run_inside_their_spans(monkeypatch):
    """On the card's route (a tensor on no CPU; here the launchers stood in
    for on meta tensors) K11 runs inside ``prefilter.coefficients`` and
    K12 inside ``prefilter.transpose``."""
    inside = []

    def launcher(name):
        def fn(t):
            inside.append((name, torch.autograd.profiler._is_profiler_enabled))
            return torch.empty_like(t)
        return fn

    monkeypatch.setattr(native, "launch_prefilter", launcher("K11"))
    monkeypatch.setattr(native, "launch_prefilter_bwd", launcher("K12"))
    f = torch.empty(4, 5, 6, 4, device="meta", requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = native.bspline_prefilter(f)
        torch.autograd.grad(out, f, torch.empty_like(out))
    spans = {ev.name: ev.time_range for ev in prof.events()
             if ev.name.startswith("prefilter.")}
    assert set(spans) == {"prefilter.coefficients", "prefilter.transpose"}
    assert [n for n, _ in inside] == ["K11", "K12"]
    # without a profiler the launchers run alike and no range is made
    inside.clear()
    out = native.bspline_prefilter(f)
    torch.autograd.grad(out, f, torch.empty_like(out))
    assert inside == [("K11", False), ("K12", False)]


def test_block_ray_order_sorts_each_block_by_where_its_rays_cross():
    """``block_ray_order`` permutes the rays; each run of ``ORDER_BLOCK``
    rays keeps its place and is sorted by the Morton code of the
    1/8-voxel cell where the ray crosses the volume's middle plane, so a
    warp's rays sit together; a ray parallel to the planes (cz = 0) or
    off the grid gets a code and no error."""
    from photon_tpu_torch.ops.march_dense import march_geometry
    from photon_tpu_torch.ops.march_dense_fused import (ORDER_BLOCK,
                                                        _morton16,
                                                        block_ray_order)
    vol = build_density_volume(np.full((N, N, N), 1.2), [1e3] * 3,
                               [-6e3, -6e3, 4e5], device="cpu")
    g = march_geometry(vol)
    P = 3 * ORDER_BLOCK + 37
    gen = torch.Generator().manual_seed(5)
    x0 = torch.rand(P, generator=gen) * 1.6e4 - 8e3
    y0 = torch.rand(P, generator=gen) * 1.6e4 - 8e3
    cx = torch.randn(P, generator=gen) * 1e-2
    cy = torch.randn(P, generator=gen) * 1e-2
    cz = -torch.sqrt(1.0 - cx * cx - cy * cy)
    cz[7] = 0.0
    rays = torch.stack([x0, y0, torch.full((P,), 5e5), cx, cy, cz])
    order = block_ray_order(rays, g)
    assert torch.equal(torch.sort(order).values, torch.arange(P))
    assert torch.equal(order // ORDER_BLOCK, torch.arange(P) // ORDER_BLOCK)
    z_mid = 0.5 * (float(g.z_min) + float(g.z_max))
    t = (z_mid - rays[2]) / rays[5]
    cells = []
    for p0, c, lo, step in ((x0, cx, g.min_x, g.sx), (y0, cy, g.min_y,
                                                        g.sy)):
        u = torch.nan_to_num((p0 + c * t - float(lo)) / float(step),
                             nan=0.0, posinf=0.0, neginf=0.0)
        cells.append(((u + 4.0) * 8.0).clamp(0.0, 65535.0).long())
    code = _morton16(cells[0]) | (_morton16(cells[1]) << 1)
    for b in range(0, P, ORDER_BLOCK):
        run = code[order[b:b + ORDER_BLOCK]]
        assert bool((run[1:] >= run[:-1]).all())
    # neighbours in the order are neighbours in the volume: a run's rays
    # lie closer to the next in the order than in the caller's order
    pos = torch.stack(cells, 1).double()
    step_sorted = (pos[order[1:]] - pos[order[:-1]]).norm(dim=1).median()
    step_input = (pos[1:] - pos[:-1]).norm(dim=1).median()
    assert float(step_sorted) < 0.5 * float(step_input)
