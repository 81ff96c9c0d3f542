"""Dense chief-ray march, plain PyTorch version.

Counterpart of ``photon_tpu/ops/march_dense.py``.  The production fast
path marches one *chief ray per particle* through the density volume and
broadcasts its deflection to the particle's ray fan (exact to the ~1 um
lens-cone width).  The JAX package evaluates the trilinear interpolation
densely, as a matrix product against hat weights
``max(0, 1 - |clip(u, 0, n-1) - i|)``, because a TPU cannot gather.  Those
weights have at most two nonzeros per axis, at ``floor(clip(u))`` and its
upper neighbour, so the same sample is a two-tap clamped gather per axis:
that is what this module does, and what the CUDA kernel of
``ops/march_dense_fused.py`` does per thread.

The integrator is the exact (non-paraxial) eikonal ODE in the z
parametrisation (Sharma's T = n * dr/ds):

    d(x, y)/dz = (T_x / T_z, T_y / T_z)
    dT/dz      = (n / T_z) * grad(n)

with one step per z slab.  Integrators: 1 = Euler, 2 = RK4, 3 = RK4 with
``substeps`` substeps per slab (default 2).  Interpolation scheme 1
(trilinear).  Tricubic (scheme 2), AB4 (algorithm 4) and the data-driven
``choose_substeps`` are later items of ROADMAP.md.

This module is the plain version of the march kernel: the CPU tests and the
on-card comparison use it; on a CUDA device the renderer goes through
``march_dense_fused.march_chief_fused``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch.roadmap import AB4, TRICUBIC, later
from photon_tpu_torch.volume import DensityVolume

# slab-area ceiling of the dense tier (the JAX package's routing on its
# accelerator); larger volumes belong to the large-volume march
DENSE_MAX_SLAB = 256 * 256


def dense_march_supported(vol: DensityVolume) -> bool:
    w, h, _ = vol.sizes
    return int(w) * int(h) <= DENSE_MAX_SLAB


class MarchGeometry(NamedTuple):
    """Geometry scalars of a volume, formed in float32 like the JAX package
    forms them (f32 bounds, f32 arithmetic)."""
    min_x: np.float32
    min_y: np.float32
    sx: np.float32
    sy: np.float32
    z_min: np.float32
    z_max: np.float32
    dz_slab: np.float32
    n0: np.float32

    def z_planes(self, d: int) -> np.ndarray:
        """Landing planes, top-down: voxel-centre z's, the last clamped to
        z_min (the march domain is [z_min, z_max])."""
        ks = np.arange(d - 2, -1, -1, dtype=np.float32)
        planes = self.z_min + (ks - np.float32(0.5)) * self.dz_slab
        return np.maximum(planes, self.z_min).astype(np.float32)


def march_geometry(vol: DensityVolume) -> MarchGeometry:
    w, h, d = (int(s) for s in vol.sizes)
    if min(w, h, d) < 3:
        raise ValueError(f"volume {w}x{h}x{d}: every axis needs >= 3 voxels")
    mn = np.asarray(vol.min_bound, dtype=np.float32)
    mx = np.asarray(vol.max_bound, dtype=np.float32)
    f = np.float32
    return MarchGeometry(
        min_x=mn[0], min_y=mn[1],
        sx=(mx[0] - mn[0]) / f(w - 2.0), sy=(mx[1] - mn[1]) / f(h - 2.0),
        z_min=mn[2], z_max=mx[2], dz_slab=(mx[2] - mn[2]) / f(d - 2.0),
        n0=f(1.0) + f(vol.data_min))


def check_march_options(algorithm: int, interpolation_scheme: int) -> None:
    """Raise for the integrators and schemes that later slices port."""
    if interpolation_scheme != 1:
        raise later("tricubic interpolation (scheme 2)", TRICUBIC)
    if algorithm not in (1, 2, 3):
        raise later(f"ray_tracing_algorithm {algorithm}", AB4)


def resolve_substeps(algorithm: int, substeps: Optional[int]) -> int:
    if substeps is None:
        substeps = 2 if algorithm == 3 else 1
    return max(1, int(substeps))


def _two_tap(u, n: int):
    """Clamp-then-hat addressing: lower tap index and upper-tap weight."""
    uc = torch.nan_to_num(u, nan=0.0).clamp(0.0, n - 1.0)
    i0 = uc.floor().clamp(max=n - 2.0)
    return i0.long(), uc - i0


def _slab_sample(lo, hi, ux, uy, uz, w: int, h: int):
    """(grad n, n-1) at (P,) voxel coordinates between two (H*W, 4) slabs:
    `lo` weighted 1-uz, `hi` weighted uz."""
    ix, fx = _two_tap(ux, w)
    iy, fy = _two_tap(uy, h)
    o00 = iy * w + ix
    o10 = o00 + w
    w00 = ((1.0 - fy) * (1.0 - fx))[:, None]
    w01 = ((1.0 - fy) * fx)[:, None]
    w10 = (fy * (1.0 - fx))[:, None]
    w11 = (fy * fx)[:, None]

    def bilinear(slab):
        return (w00 * slab[o00] + w01 * slab[o00 + 1]
                + w10 * slab[o10] + w11 * slab[o10 + 1])

    s = (1.0 - uz)[:, None] * bilinear(lo) + uz[:, None] * bilinear(hi)
    return s[:, 0], s[:, 1], s[:, 2], s[:, 3]


def march_chief_dense(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                      algorithm: int = 2, interpolation_scheme: int = 1,
                      substeps: Optional[int] = None):
    """March (P,) chief rays through the volume; plain PyTorch.

    Rays that do not intersect the volume's z range (or travel upward)
    pass through unchanged; returns (x, y, z, dirx, diry, dirz) after
    traversal.  Runs on whatever device the tensors lie on, and is safe
    under ``torch.autograd`` with respect to ``vol.field`` and the rays: a
    ray outside a slab's band takes no part in that slab's arithmetic, so a
    grazing ray (Tz near 0) cannot put ``0 * inf`` into the field's
    gradient, which sums over rays.
    """
    check_march_options(algorithm, interpolation_scheme)
    w, h, d = (int(s) for s in vol.sizes)
    g = march_geometry(vol)
    substeps = resolve_substeps(algorithm, substeps)
    slabs = vol.field.reshape(d, h * w, 4)
    min_x, min_y, sx, sy = (float(v) for v in (g.min_x, g.min_y, g.sx, g.sy))
    z_min, z_max, dz_slab = float(g.z_min), float(g.z_max), float(g.dz_slab)
    n0 = float(g.n0)

    # entry advance to the volume top
    t_entry = (z_max - zs) / dcz
    above = zs >= z_max
    adv = torch.where(above, t_entry.clamp_min(0.0), torch.zeros_like(zs))
    x = xs + dcx * adv
    y = ys + dcy * adv
    z = torch.where(above, torch.full_like(zs, z_max), zs + dcz * adv)
    inside = (z <= z_max) & (z >= z_min) & (dcz < 0)

    Tx = n0 * dcx
    Ty = n0 * dcy
    Tz = n0 * dcz

    def rhs(lo, hi, z_plane, st, z_at, in_band):
        px, py, tx, ty, tz = st
        uz = ((z_at - z_plane) / dz_slab).clamp(0.0, 1.0)
        ux = 0.5 + (px - min_x) / sx
        uy = 0.5 + (py - min_y) / sy
        gx, gy, gz, nm1 = _slab_sample(lo, hi, ux, uy, uz, w, h)
        # 1/tz only where the step is taken (the value is unchanged there)
        inv_tz = 1.0 / torch.where(in_band, tz, torch.ones_like(tz))
        gn = (1.0 + nm1) * inv_tz
        return (tx * inv_tz, ty * inv_tz, gn * gx, gn * gy, gn * gz)

    def axpy(st, hh, k):
        return tuple(v + hh * kk for v, kk in zip(st, k))

    def rk4(lo, hi, z_plane, st, hh, z0, in_band):
        k1 = rhs(lo, hi, z_plane, st, z0, in_band)
        h2 = hh / 2.0
        k2 = rhs(lo, hi, z_plane, axpy(st, h2, k1), z0 + h2, in_band)
        k3 = rhs(lo, hi, z_plane, axpy(st, h2, k2), z0 + h2, in_band)
        k4 = rhs(lo, hi, z_plane, axpy(st, hh, k3), z0 + hh, in_band)
        s6 = hh / 6.0
        return tuple(v + s6 * (a + 2.0 * b + 2.0 * c + dd)
                     for v, a, b, c, dd in zip(st, k1, k2, k3, k4))

    for s, z_plane in enumerate(g.z_planes(d).tolist()):
        ks = d - 2 - s
        lo, hi = slabs[ks], slabs[ks + 1]
        in_band = inside & (z > z_plane)
        hstep = -(z - z_plane)
        st = (x, y, Tx, Ty, Tz)
        if algorithm == 1:
            new = axpy(st, hstep, rhs(lo, hi, z_plane, st, z, in_band))
        elif substeps == 1:
            new = rk4(lo, hi, z_plane, st, hstep, z, in_band)
        else:
            hs = hstep / substeps
            new = st
            for si in range(substeps):
                new = rk4(lo, hi, z_plane, new, hs, z + si * hs, in_band)
        x = torch.where(in_band, new[0], x)
        y = torch.where(in_band, new[1], y)
        z = torch.where(in_band, torch.full_like(z, z_plane), z)
        Tx = torch.where(in_band, new[2], Tx)
        Ty = torch.where(in_band, new[3], Ty)
        Tz = torch.where(in_band, new[4], Tz)

    Tn = torch.sqrt(Tx * Tx + Ty * Ty + Tz * Tz)
    dirx_f = torch.where(inside, Tx / Tn, dcx)
    diry_f = torch.where(inside, Ty / Tn, dcy)
    dirz_f = torch.where(inside, Tz / Tn, dcz)
    return x, y, z, dirx_f, diry_f, dirz_f


def chief_deltas_dense(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                       algorithm: int = 2, interpolation_scheme: int = 1,
                       substeps: Optional[int] = None):
    """Exit plane and curvature deltas of the chief rays.

    Returns ``(z_exit, dpos_x, dpos_y, ddir_x, ddir_y, ddir_z)``, each
    (P,): the chief ray's exit plane and its deviation from the
    straight-line continuation.  The march goes through
    ``march_dense_fused.march_chief_fused`` (the CUDA kernel for tensors on
    the card, this module's plain march for tensors on the CPU).
    """
    from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
    x1, y1, z1, dx1, dy1, dz1 = march_chief_fused(
        vol, xs, ys, zs, dcx, dcy, dcz, algorithm=algorithm,
        interpolation_scheme=interpolation_scheme, substeps=substeps)
    t = (z1 - zs) / dcz
    return (z1, x1 - (xs + dcx * t), y1 - (ys + dcy * t),
            dx1 - dcx, dy1 - dcy, dz1 - dcz)
