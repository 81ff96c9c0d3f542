"""What the chief rays of a march need: the ray-slab steps they take and
the voxels they touch.  Copied from ``chip_smoke.py`` (``in_band_steps``,
``touched_voxels``), on the reference's geometry.

f32 operations of the march's formulas (add, mul, div, sqrt, compare each
one), from the kernels' sources, counted by hand in ``chip_smoke.py``."""
from __future__ import annotations

MARCH_OPS_PER_RHS = 100       # coordinates 15, weights 10, 8-voxel blend 68, rhs 7
MARCH_OPS_PER_RK4_COMBINE = 65
# a stage's sample recompute and VJP (coordinates 15, weights 10, blend 68,
# rhs 7, cotangents 20, scatter products 40, tap dots 56, coordinate
# cotangents 45) and the per-slab combine
MARCH_VJP_OPS_PER_STAGE = 260
MARCH_VJP_OPS_PER_COMBINE = 120


def _planes(g, dev):
    import torch
    return torch.as_tensor(g.z_planes(), dtype=torch.float32, device=dev)


def in_band_steps(g, rays) -> int:
    """Ray-slab steps that these rays take through the volume."""
    import torch
    z0, cz = rays[2], rays[5]
    z_in = torch.where(z0 >= g.z_max, torch.full_like(z0, g.z_max), z0)
    ins = (z_in >= g.z_min) & (cz < 0)
    pl = _planes(g, z0.device)
    total = 0
    for s in range(0, pl.shape[0], 64):
        total += int(((z_in[:, None] > pl[None, s:s + 64])
                      & ins[:, None]).sum())
    return total


def touched_voxels(g, rays, slabs_at_once: int = 16) -> int:
    """Distinct voxels under the 2 x 2 x 2 footprints of these rays'
    trilinear samples at the top, the middle and the bottom of every slab a
    ray crosses (where RK4 samples), on both planes of the slab's pair.
    Straight rays: the bench's volumes bend them by far less than a voxel.
    It is what the march must read of the field."""
    import torch
    w, h, d = g.w, g.h, g.d
    x0, y0, z0, cx, cy, cz = rays
    dev = x0.device
    z_in = torch.where(z0 >= g.z_max, torch.full_like(z0, g.z_max), z0)
    inside = (z_in >= g.z_min) & (cz < 0)
    planes = _planes(g, dev)
    above = torch.cat([planes.new_tensor([g.z_max]), planes[:-1]])
    mask = torch.zeros((d, h * w), dtype=torch.bool, device=dev)
    for s0 in range(0, d - 1, slabs_at_once):
        zb = planes[s0:s0 + slabs_at_once, None]
        zt = torch.minimum(above[s0:s0 + slabs_at_once, None], z_in[None])
        band = inside[None] & (zt > zb)
        ks = (d - 2 - torch.arange(s0, s0 + zb.shape[0], device=dev)
              )[:, None].expand_as(band)[band]
        for frac in (0.0, 0.5, 1.0):
            t = (zt + frac * (zb - zt) - z0[None]) / cz[None]
            ux = 0.5 + (x0[None] + cx[None] * t - g.min_x) / g.sx
            uy = 0.5 + (y0[None] + cy[None] * t - g.min_y) / g.sy
            ix = ux.clamp(0.0, w - 1.0).long().clamp_max(w - 2)
            iy = uy.clamp(0.0, h - 1.0).long().clamp_max(h - 2)
            o00 = (iy * w + ix)[band]
            for plane in (ks, ks + 1):
                for tap in (0, 1, w, w + 1):
                    mask[plane, o00 + tap] = True
    return int(mask.sum())
