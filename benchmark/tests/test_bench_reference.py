"""The plain reference against the program's plain versions on the CPU,
and its hand-written march backward against autograd through its own
forward."""
import numpy as np
import torch

from benchmark.reference import render as R


def rays_through(g, P, gen):
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(P, generator=gen)  # noqa
    tx, ty = u(-0.02, 0.02), u(-0.02, 0.02)
    inv = torch.rsqrt(tx * tx + ty * ty + 1.0)
    return [g.min_x + g.sx * u(1.0, g.w - 3.0),
            g.min_y + g.sy * u(1.0, g.h - 3.0),
            torch.full((P,), g.z_max + 3.0), tx * inv, ty * inv, -inv]


def test_march_backward_is_autograd_through_the_march():
    gen = torch.Generator().manual_seed(3)
    g = R.geometry((12, 10, 9), [2.0, 3.0, 5.0], [0.0, 0.0, 750e3 - 50.0],
                   1e-3)
    field = (torch.rand((9, 10, 12, 4), generator=gen) - 0.5) * 2e-3
    rays = rays_through(g, 64, gen)
    ct = [torch.randn(64, generator=gen) for _ in range(6)]
    ct[0] = torch.zeros(64)
    deltas, tape = R.march_deltas(field, g, rays, keep=True)
    got = R.march_backward(field, g, rays, tape, tuple(ct))
    f = field.clone().requires_grad_(True)
    S, z, inside = R.march_all(f, g, rays)
    want, = torch.autograd.grad(R._exit_deltas(S, z, inside, rays)[1:], f,
                                grad_outputs=ct[1:])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-6 * want.abs().max())
    assert want.abs().max() > 0


def test_march_against_the_programs_plain_march():
    from photon_tpu_torch.ops.march_dense import march_chief_dense
    from photon_tpu_torch.volume import DensityVolume
    gen = torch.Generator().manual_seed(4)
    sizes, sp, origin = (12, 10, 9), [2.0, 3.0, 5.0], [0.0, 0.0, 10.0]
    g = R.geometry(sizes, sp, origin, 1e-3)
    field = (torch.rand((9, 10, 12, 4), generator=gen) - 0.5) * 2e-3
    o = np.array(origin, np.float64)
    o[2] -= 750e3
    vol = DensityVolume(
        field=field, min_bound=o.astype(np.float32),
        max_bound=(o + (np.array(sizes) - 1.0) * sp).astype(np.float32),
        grid_spacing=np.float32(sp), data_min=1e-3, step_size=2.0,
        max_step_size=5.0)
    rays = rays_through(g, 64, gen)
    S, z, inside = R.march_all(field, g, rays)
    x1, y1, z1, *_ = march_chief_dense(vol, *rays, algorithm=2)
    assert torch.allclose(S[0], x1, rtol=0, atol=1e-3)
    assert torch.allclose(S[1], y1, rtol=0, atol=1e-3)
    assert torch.equal(z, z1)
