"""K4 under the cubic scheme (``csrc/march_bwd.cu``,
``march_bwd_stage_kernel<2>``), RK4 from the stage residual: the residual
and the rays' columns read, the coefficients under the rays' 4 x 4
footprints read once, the coefficients' gradient written once.

f32 operations of a stage, counted by hand from ``vjp_stage<2>`` and
``march_common.cuh``'s ``sample<2>`` and ``sample_vjp<2>`` (add, mul, div,
compare, select, min / max each one): the coordinates 15; the two axes'
four weights for the sample recompute 180 (clamp and floor 6, and a tap
21: its index, B3's two branches and their selects); the 4 x 4 x 2 blend
301 (a tap's weight and 8 products and 8 sums, 16 row offsets, the blend
in z 13); the right-hand side 7; the sample's cotangent 20; the two axes'
weights and B3' again for the VJP 332; the 16 taps' two dots and their
coordinate sums 448; four rows of eight-tap scatter products and merges
160; the rows' sums 24; the state's cotangent 10.  The step's combine is
the trilinear one's."""
from benchmark.counts.march_common import (MARCH_VJP_OPS_PER_COMBINE,
                                           _planes)

TAG = "march_bwd_stage_kernel<2>"
COUNTER = ("photon_tpu_torch.ops.march_dense_fused", "march_backward_stage")

CUBIC_VJP_OPS_PER_STAGE = (15 + 180 + 301 + 7 + 20 + 332 + 448 + 160 + 24
                           + 10)


def work(shape):
    P, steps = shape["rays"], shape["steps"]
    ops = steps * (4 * CUBIC_VJP_OPS_PER_STAGE + MARCH_VJP_OPS_PER_COMBINE)
    nbytes = (steps * 20 * 4 + 21 * P * 4 + shape["touched"] * 16
              + shape["field_voxels"] * 16)
    return ops, nbytes


def touched_coefficients(g, rays, slabs_at_once: int = 16) -> int:
    """Distinct coefficients under the 4 x 4 footprints of these rays'
    cubic samples at the top, the middle and the bottom of every slab a
    ray crosses (where RK4 samples), on both planes of the slab's pair
    (``march_common.touched_voxels``' rule with the cubic taps: floor(u) - 1
    .. floor(u) + 2 of the coordinate clamped into [-2, n+1], clipped into
    the grid).  Straight rays: the bench's volumes bend them by far less
    than a voxel."""
    import torch
    w, h, d = g.w, g.h, g.d
    x0, y0, z0, cx, cy, cz = rays
    dev = x0.device
    z_in = torch.where(z0 >= g.z_max, torch.full_like(z0, g.z_max), z0)
    inside = (z_in >= g.z_min) & (cz < 0)
    planes = _planes(g, dev)
    above = torch.cat([planes.new_tensor([g.z_max]), planes[:-1]])
    mask = torch.zeros((d, h * w), dtype=torch.bool, device=dev)
    taps = torch.arange(4, device=dev)
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
            ix = ux.clamp(-2.0, w + 1.0).floor().long()[band]
            iy = uy.clamp(-2.0, h + 1.0).floor().long()[band]
            cols = (ix[:, None] - 1 + taps).clamp(0, w - 1)
            rows = (iy[:, None] - 1 + taps).clamp(0, h - 1)
            flat = (rows[:, :, None] * w + cols[:, None, :]).reshape(-1, 16)
            for plane in (ks, ks + 1):
                mask[plane[:, None].expand_as(flat), flat] = True
    return int(mask.sum())
