"""Dense chief-ray march, plain PyTorch version.

Counterpart of ``photon_tpu/ops/march_dense.py``.  The production fast
path marches one *chief ray per particle* through the density volume and
broadcasts its deflection to the particle's ray fan (exact to the ~1 um
lens-cone width).  The JAX package evaluates the trilinear interpolation
densely, as a matrix product against hat weights
``max(0, 1 - |clip(u, 0, n-1) - i|)``, because a TPU cannot gather.  Those
weights have at most two nonzeros per axis, at ``floor(clip(u))`` and its
upper neighbour, so the same sample is a two-tap clamped gather per axis
(four taps for the cubic weights): that is what the plain sampler of
``ops/march_dense_sampler.py`` does, and what the CUDA kernels do per thread.

The integrator is the exact (non-paraxial) eikonal ODE in the z
parametrisation (Sharma's T = n * dr/ds):

    d(x, y)/dz = (T_x / T_z, T_y / T_z)
    dT/dz      = (n / T_z) * grad(n)

with one step per z slab.  Integrators: 1 = Euler, 2 = RK4, 3 = RK4 with
``substeps`` substeps per slab (2 unless given; :func:`choose_substeps`
picks the count from the data), 4 = Adams-Bashforth-4 with a per-ray RK4
bootstrap.  Interpolation schemes: 1 = trilinear, 2 = cubic B-spline in x
and y over coefficients prefiltered along all three axes
(:func:`bspline_prefilter`), blended linearly in z.

One loop (:func:`_march_chief`) serves two entries that differ in the
sampler each integrator stage calls.  :func:`march_chief_dense` is the plain
version of the march kernels: always the PyTorch gather
(``march_dense_sampler.slab_sample_plain``), on any device; the CPU tests and
the on-card comparisons use it.  :func:`march_chief_per_stage` runs the same
loop over ``march_dense_sampler.dense_slab_sample`` (the sampler kernels for
tensors on the card) and is what ``march_dense_fused.march_chief_fused`` takes
where no fused kernel covers the integrator.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch.ops.march_dense_sampler import (check_scheme,
                                                      dense_slab_sample,
                                                      slab_sample_plain)
from photon_tpu_torch.roadmap import LARGE_VOLUMES, later
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
    """Raise for an integrator or scheme outside the menu."""
    check_scheme(interpolation_scheme)
    if algorithm not in (1, 2, 3, 4):
        raise ValueError(f"unknown ray_tracing_algorithm {algorithm}")


def resolve_substeps(algorithm: int, substeps: Optional[int]) -> int:
    if substeps is None:
        substeps = 2 if algorithm == 3 else 1
    return max(1, int(substeps))


# ---------------------------------------------------------------------------
# Cubic B-spline prefilter
# ---------------------------------------------------------------------------

_POLE = float(np.sqrt(3.0) - 2.0)


def _prefilter_axis(x, axis: int):
    """Causal then anticausal recursive filter along one axis, in f32."""
    f = np.float32
    z = f(_POLE)
    lam = float(f((1.0 - _POLE) * (1.0 - 1.0 / _POLE)))
    last = float(z / (z * z - f(1.0)))
    z = float(z)
    x = x.movedim(axis, 0)
    n = x.shape[0]
    horizon = min(n, max(12, int(math.ceil(math.log(1e-7)
                                           / math.log(abs(_POLE))))))
    zk = torch.as_tensor((_POLE ** np.arange(horizon)).astype(np.float32),
                         device=x.device)
    zk = zk.reshape((horizon,) + (1,) * (x.dim() - 1))
    causal = [lam * (zk * x[:horizon]).sum(0)]
    for i in range(1, n):
        causal.append(lam * x[i] + z * causal[-1])
    out = [None] * n
    out[n - 1] = last * (z * causal[n - 2] + causal[n - 1])
    for i in range(n - 2, -1, -1):
        out[i] = z * (out[i + 1] - causal[i])
    return torch.stack(out).movedim(0, axis)


def bspline_prefilter(field):
    """(D, H, W, C) samples -> cubic B-spline coefficients, along axes 0, 1
    and 2; differentiable (``torch.autograd`` gives the transpose), on the
    field's device.  Pole sqrt(3) - 2, the causal start summed over a
    horizon of at most 12 .. n terms."""
    out = field
    for axis in (0, 1, 2):
        out = _prefilter_axis(out, axis)
    return out.contiguous()


# ---------------------------------------------------------------------------
# The march
# ---------------------------------------------------------------------------

def _march_chief(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                 algorithm: int, interpolation_scheme: int,
                 substeps: Optional[int], sampler):
    """The slab loop of both entries; ``sampler`` is called once per
    integrator stage as ``sampler(lo, hi, ux, uy, uz, scheme)``."""
    check_march_options(algorithm, interpolation_scheme)
    w, h, d = (int(s) for s in vol.sizes)
    g = march_geometry(vol)
    substeps = resolve_substeps(algorithm, substeps)
    field = vol.field
    if interpolation_scheme == 2:
        field = bspline_prefilter(field)
    slabs = field.unbind(0)
    min_x, min_y, sx, sy = (float(v) for v in (g.min_x, g.min_y, g.sx, g.sy))
    z_min, z_max, dz_slab = float(g.z_min), float(g.z_max), float(g.dz_slab)
    n0 = float(g.n0)
    ab4 = algorithm == 4

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
        gx, gy, gz, nm1 = sampler(lo, hi, ux, uy, uz, interpolation_scheme)
        # 1/tz only where the step is taken (the value is unchanged there)
        inv_tz = 1.0 / torch.where(in_band, tz, torch.ones_like(tz))
        gn = (1.0 + nm1) * inv_tz
        return (tx * inv_tz, ty * inv_tz, gn * gx, gn * gy, gn * gz)

    def axpy(st, hh, k):
        return tuple(v + hh * kk for v, kk in zip(st, k))

    def rk4(lo, hi, z_plane, st, hh, z0, in_band, k1=None):
        if k1 is None:
            k1 = rhs(lo, hi, z_plane, st, z0, in_band)
        h2 = hh / 2.0
        k2 = rhs(lo, hi, z_plane, axpy(st, h2, k1), z0 + h2, in_band)
        k3 = rhs(lo, hi, z_plane, axpy(st, h2, k2), z0 + h2, in_band)
        k4 = rhs(lo, hi, z_plane, axpy(st, hh, k3), z0 + hh, in_band)
        s6 = hh / 6.0
        return tuple(v + s6 * (a + 2.0 * b + 2.0 * c + dd)
                     for v, a, b, c, dd in zip(st, k1, k2, k3, k4))

    if ab4:
        # committed steps of each ray and its last three right-hand sides,
        # oldest first; both move only where a step is taken
        nstep = torch.zeros_like(x, dtype=torch.int32)
        hist = tuple(tuple(torch.zeros_like(x) for _ in range(5))
                     for _ in range(3))

    for s, z_plane in enumerate(g.z_planes(d).tolist()):
        ks = d - 2 - s
        lo, hi = slabs[ks], slabs[ks + 1]
        in_band = inside & (z > z_plane)
        hstep = -(z - z_plane)
        st = (x, y, Tx, Ty, Tz)
        if algorithm == 1:
            new = axpy(st, hstep, rhs(lo, hi, z_plane, st, z, in_band))
        elif ab4:
            # RK4 for the first three committed steps of each ray, then
            # Adams-Bashforth over the stored right-hand sides; the
            # right-hand side at the step's entry is also RK4's first stage
            f_now = rhs(lo, hi, z_plane, st, z, in_band)
            rk = rk4(lo, hi, z_plane, st, hstep, z, in_band, k1=f_now)
            h24 = hstep / 24.0
            adams = tuple(
                v + h24 * (55.0 * fn - 59.0 * hist[2][i] + 37.0 * hist[1][i]
                           - 9.0 * hist[0][i])
                for i, (v, fn) in enumerate(zip(st, f_now)))
            boot = nstep < 3
            new = tuple(torch.where(boot, r, a) for r, a in zip(rk, adams))
            nstep = nstep + in_band.to(torch.int32)
            hist = tuple(
                tuple(torch.where(in_band, fn, fo)
                      for fn, fo in zip(h_new, h_old))
                for h_new, h_old in zip((hist[1], hist[2], f_now), hist))
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


def march_chief_dense(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                      algorithm: int = 2, interpolation_scheme: int = 1,
                      substeps: Optional[int] = None):
    """March (P,) chief rays through the volume; plain PyTorch.

    Rays that do not intersect the volume's z range (or travel upward)
    pass through unchanged; returns (x, y, z, dirx, diry, dirz) after
    traversal.  Runs on whatever device the tensors lie on and launches no
    kernel of this package.  Safe under ``torch.autograd`` with respect to
    ``vol.field`` and the rays: a ray outside a slab's band takes no part in
    that slab's arithmetic, so a grazing ray (Tz near 0) cannot put
    ``0 * inf`` into the field's gradient, which sums over rays.  For
    ``interpolation_scheme=2`` the prefilter runs here: pass raw samples,
    not coefficients.
    """
    return _march_chief(vol, xs, ys, zs, dcx, dcy, dcz, algorithm=algorithm,
                        interpolation_scheme=interpolation_scheme,
                        substeps=substeps, sampler=slab_sample_plain)


def march_chief_per_stage(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                          algorithm: int = 2, interpolation_scheme: int = 1,
                          substeps: Optional[int] = None):
    """The same march with every integrator stage sampled through
    ``dense_slab_sample``: the sampler kernels, forward and backward, for
    tensors on the card, with the stage arithmetic in PyTorch around them.
    Under autograd every stage keeps some forty (P,) tensors alive until the
    backward pass."""
    return _march_chief(vol, xs, ys, zs, dcx, dcy, dcz, algorithm=algorithm,
                        interpolation_scheme=interpolation_scheme,
                        substeps=substeps, sampler=dense_slab_sample)


def choose_substeps(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                    interpolation_scheme: int = 1, budget: float = 0.01,
                    max_substeps: int = 16, sample: int = 1024) -> int:
    """Error-controlled substep count for algorithm 3.

    Marches a subsample of at most ``sample`` chief rays at 2 and at 4
    substeps, takes the Richardson estimate of the 4-substep deflection
    error (RK4 is O(h^4): err(4) ~ |d4 - d2| / 15) relative to the largest
    deflection, and scales it to ``budget``: 2, 4, or
    ``ceil(4 (err4 / budget)^(1/4))`` capped at ``max_substeps``.  The rays
    are (P,) tensors on the volume's device; the two marches go through
    ``march_chief_fused`` without gradients.
    """
    from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
    if not dense_march_supported(vol):
        raise later("choose_substeps beyond the dense tier (slabs over "
                    "256x256)", LARGE_VOLUMES)
    P = xs.shape[0]
    if P > sample:
        idx = np.linspace(0, P - 1, sample).astype(np.int64)
    else:
        idx = np.arange(P)
    idx = torch.as_tensor(idx, device=xs.device)
    sub = [t.detach()[idx].contiguous() for t in (xs, ys, zs, dcx, dcy, dcz)]
    probe = vol._replace(field=vol.field.detach())

    def exit_dirs(n):
        with torch.no_grad():
            r = march_chief_fused(probe, *sub, algorithm=3,
                                  interpolation_scheme=interpolation_scheme,
                                  substeps=n)
        return torch.stack(r[3:6], -1).cpu().numpy()

    d2 = exit_dirs(2)
    d4 = exit_dirs(4)
    d0 = torch.stack(sub[3:6], -1).cpu().numpy()
    defl = np.linalg.norm(d4 - d0, axis=1)
    scale = max(float(defl.max()), 1e-12)
    err4 = float(np.linalg.norm(d4 - d2, axis=1).max()) / 15.0 / scale
    if err4 <= budget:
        return 2 if err4 * (4.0 / 2.0) ** 4 <= budget else 4
    # err(n) ~ err4 * (4/n)^4  ->  n >= 4 * (err4/budget)^(1/4)
    n = int(np.ceil(4.0 * (err4 / budget) ** 0.25))
    return int(min(max(n, 4), max_substeps))


def chief_deltas_dense(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                       algorithm: int = 2, interpolation_scheme: int = 1,
                       substeps: Optional[int] = None):
    """Exit plane and curvature deltas of the chief rays.

    Returns ``(z_exit, dpos_x, dpos_y, ddir_x, ddir_y, ddir_z)``, each
    (P,): the chief ray's exit plane and its deviation from the
    straight-line continuation.  The march goes through
    ``march_dense_fused.march_chief_fused`` (the CUDA kernels for tensors on
    the card, this module's plain march for tensors on the CPU).
    """
    from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
    x1, y1, z1, dx1, dy1, dz1 = march_chief_fused(
        vol, xs, ys, zs, dcx, dcy, dcz, algorithm=algorithm,
        interpolation_scheme=interpolation_scheme, substeps=substeps)
    t = (z1 - zs) / dcz
    return (z1, x1 - (xs + dcx * t), y1 - (ys + dcy * t),
            dx1 - dcx, dy1 - dcy, dz1 - dcz)
