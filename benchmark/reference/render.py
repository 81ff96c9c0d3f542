"""The plain reference of the fast render, forward and (for the inversion)
backward, in PyTorch alone.

Frozen copies of the port's plain versions (``photon_tpu_torch``'s
``models/render_fast.py``, ``models/render.RenderParams``,
``ops/march_dense.py``, ``ops/march_dense_sampler.slab_sample_plain``,
``ops/march_fast.py``, ``ops/fan.py``, ``ops/sensor_fast.py`` and
``native.grad_axis`` / ``gradient_field_plain``), cut to the route that the
benchmark's cells take: the axis-aligned single-lens train under an
unrotated camera, one erf spot a particle, a chief ray a particle marched
by RK4 under trilinear interpolation.  Other routes raise.

Two things are the reference's own.  The march keeps each slab's entry state
and runs its backward slab by slab in reverse (``torch.autograd`` over one
slab's step at a time, the field's gradient added into the two slabs that
step read), so that a gradient through 511 slabs of 120,000 rays fits and
takes seconds.  And every function takes ``lowp``, a rounding applied to the
field and to the image: ``None`` is float32 throughout; :func:`bf16` is the
control, the same arithmetic with the field and the image stored in
bfloat16.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

Lowp = Optional[Callable[[torch.Tensor], torch.Tensor]]


def bf16(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding: to bfloat16 and back."""
    return t.to(torch.bfloat16).to(t.dtype)


def _round(t, lowp: Lowp):
    return t if lowp is None else lowp(t)


# ---------------------------------------------------------------------------
# Parameters (models/render.RenderParams, models/render_fast.fan_scalars,
# ops/fan.fan_constants)
# ---------------------------------------------------------------------------

@dataclass
class Params:
    nx: int
    ny: int
    pixel_pitch: float
    z_sensor: float
    lens_pitch: float
    image_distance: float
    aperture_f_number: float
    ray_cone_pitch_ratio: float
    lens_model: str
    diffraction_diameter: float
    z_offset: float
    object_distance: float
    thin_lens_focal_length: float


def params_of(cfg, setup, source) -> Params:
    cd = cfg.camera_design
    if not cd.implement_diffraction or cfg.density_gradients.add_pos_noise:
        raise NotImplementedError("the reference renders one erf spot a "
                                  "particle")
    if not np.allclose(setup.rotation_matrix, np.eye(3)):
        raise NotImplementedError("the reference renders an unrotated camera")
    st = setup.elements
    if st.num_elements != 1 or not np.allclose(st.plane_parameters[0][:3],
                                               [0, 0, 1]):
        raise NotImplementedError("the reference renders the axis-aligned "
                                  "single-lens train")
    return Params(
        nx=int(cd.x_pixel_number), ny=int(cd.y_pixel_number),
        pixel_pitch=float(cd.pixel_pitch), z_sensor=float(setup.z_sensor),
        lens_pitch=float(setup.lens_pitch),
        image_distance=float(setup.image_distance),
        aperture_f_number=float(setup.aperture_f_number),
        ray_cone_pitch_ratio=float(cfg.lens_design.ray_cone_pitch_ratio),
        lens_model=str(setup.lens_model),
        diffraction_diameter=float(cd.diffraction_diameter),
        z_offset=float(source.z_offset),
        object_distance=float(source.object_distance),
        thin_lens_focal_length=float(st.thin_lens_focal_length[0]))


@dataclass
class FanConstants:
    image_distance: float
    shift: float
    z_object: float
    magnification: float
    z_lens: float
    half_pitch_sq: float
    focal_length: float
    czf: float
    r_front: float
    czb: float
    r_back: float
    n_lens: float
    inv_n_lens: float
    z_sensor: float
    pixel_pitch: float
    pixel_1_x: float
    pixel_1_y: float
    nx_f: float
    ny_f: float
    nx_m1: float


def fan_constants(p: Params, setup) -> FanConstants:
    st = setup.elements
    z_lens, pitch = float(setup.z_lens), float(st.pitch[0])
    vertex = float(st.vertex_distance[0])
    r_front = float(st.front_surface_radius[0])
    r_back = float(st.back_surface_radius[0])
    n_lens = float(st.refractive_index[0])
    z_object = p.object_distance + p.z_offset
    f = p.thin_lens_focal_length
    half_pitch = pitch / 2.0
    return FanConstants(
        image_distance=p.image_distance, shift=p.z_offset + 750e3,
        z_object=z_object,
        magnification=f / (z_object - p.z_offset - f),
        z_lens=z_lens, half_pitch_sq=half_pitch * half_pitch,
        focal_length=f, czf=z_lens + vertex / 2.0 - r_front, r_front=r_front,
        czb=z_lens - vertex / 2.0 - r_back, r_back=r_back, n_lens=n_lens,
        inv_n_lens=1.0 / n_lens, z_sensor=p.z_sensor,
        pixel_pitch=p.pixel_pitch,
        pixel_1_x=-p.pixel_pitch * (p.nx - 1) / 2.0,
        pixel_1_y=-p.pixel_pitch * (p.ny - 1) / 2.0,
        nx_f=float(p.nx), ny_f=float(p.ny), nx_m1=float(p.nx - 1))


# ---------------------------------------------------------------------------
# Mie factor (models/render_fast.mie_irradiance, unrotated camera)
# ---------------------------------------------------------------------------

def mie_irradiance(image_distance: float, source, scattering) -> np.ndarray:
    angles = np.asarray(scattering["scattering_angle"])
    table = np.asarray(scattering["scattering_irradiance"], dtype=np.float32)
    beam = np.asarray(scattering["beam_propogation_vector"], dtype=np.float64)
    diam_idx = np.asarray(source.diameter_index, np.int32)
    dden = image_distance - np.asarray(source.z, np.float64)
    ctx = np.asarray(source.x, np.float64) / dden
    cty = np.asarray(source.y, np.float64) / dden
    cinv = 1.0 / np.sqrt(ctx * ctx + cty * cty + 1.0)
    cosang = beam[0] * ctx * cinv + beam[1] * cty * cinv + beam[2] * (-cinv)
    cosang = np.clip(cosang, -1.0, 1.0)
    a = (np.arccos(cosang) - angles[0]) / (angles[1] - angles[0])
    a0 = np.clip(np.floor(a).astype(np.int32), 0, table.shape[0] - 2)
    frac = (a - a0).astype(np.float32)
    rows = table.T[diam_idx]
    irr_l = rows[np.arange(len(a0)), a0]
    irr_u = rows[np.arange(len(a0)), a0 + 1]
    return irr_l + frac * (irr_u - irr_l)


# ---------------------------------------------------------------------------
# The volume (native.grad_axis, gradient_field_plain, inverse.volume_from_rho)
# ---------------------------------------------------------------------------

def grad_axis(f: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    n = f.shape[axis]
    take = lambda i: f.narrow(axis, i, 1)  # noqa: E731
    lo = (-1.5 * take(0) + 2.0 * take(1) - 0.5 * take(2)) / h
    interior = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) \
        / (2.0 * h)
    hi = (1.5 * take(n - 1) - 2.0 * take(n - 2) + 0.5 * take(n - 3)) / h
    return torch.cat([lo, interior, hi], dim=axis)


def gradient_field(n_minus_1: torch.Tensor, spacing) -> torch.Tensor:
    """(W, H, D) n - 1 -> (D, H, W, 4) float32 (dn/dx, dn/dy, dn/dz, n-1):
    each axis's stencil in float64, rounded once.  Built a block of z planes
    at a time, so that a 512^3 grid needs no float64 copy of the whole."""
    w, h, d = n_minus_1.shape
    dx, dy, dz = (float(s) for s in np.asarray(spacing).ravel())
    out = torch.empty((d, h, w, 4), dtype=torch.float32,
                      device=n_minus_1.device)
    block = 32
    for z0 in range(0, d, block):
        z1 = min(d, z0 + block)
        # the z stencil reaches a plane beyond the block on each side; a
        # slice's own faces are one-sided, and they are kept only where
        # they are the grid's
        b = min(d, z1 + 1)
        a = max(0, min(z0 - 1, b - 3))
        f = n_minus_1[:, :, a:b].to(torch.float64)
        gz = grad_axis(f, 2, dz)[:, :, z0 - a:z1 - a]
        fs = f[:, :, z0 - a:z1 - a]
        packed = torch.stack([grad_axis(fs, 0, dx), grad_axis(fs, 1, dy), gz,
                              fs], dim=-1)                  # (W, H, z, 4)
        out[z0:z1] = packed.permute(2, 1, 0, 3).to(torch.float32)
    return out


def volume_from_rho(rho: torch.Tensor, spacing,
                    gladstone_dale: float) -> torch.Tensor:
    """The inversion's differentiable field from rho: the stencil in
    float32 on K rho (``inverse.volume_from_rho``)."""
    n_minus_1 = gladstone_dale * rho
    sp = [float(s) for s in np.asarray(spacing).ravel()]
    packed = torch.stack([grad_axis(n_minus_1, 0, sp[0]),
                          grad_axis(n_minus_1, 1, sp[1]),
                          grad_axis(n_minus_1, 2, sp[2]),
                          n_minus_1], dim=-1)
    return packed.permute(2, 1, 0, 3).contiguous().to(torch.float32)


@dataclass
class Geometry:
    """March geometry in float32 (``ops/march_dense.march_geometry``)."""
    min_x: float
    min_y: float
    sx: float
    sy: float
    z_min: float
    z_max: float
    dz_slab: float
    n0: float
    w: int
    h: int
    d: int

    def z_planes(self) -> list:
        f = np.float32
        ks = np.arange(self.d - 2, -1, -1, dtype=np.float32)
        planes = f(self.z_min) + (ks - f(0.5)) * f(self.dz_slab)
        return np.maximum(planes, f(self.z_min)).astype(np.float32).tolist()


def geometry(sizes, spacing, space_origin, data_min: float,
             z_origin_shift: float = 750e3) -> Geometry:
    """The bounds as ``volume.build_density_volume`` forms them, then the
    march's scalars as ``march_geometry`` does."""
    w, h, d = (int(s) for s in sizes)
    sp = np.asarray(spacing, dtype=np.float64).ravel()
    origin = np.asarray(space_origin, dtype=np.float64).ravel().copy()
    origin[2] -= z_origin_shift
    mn = origin.astype(np.float32)
    mx = (origin + (np.array([w, h, d], np.float64) - 1.0) * sp).astype(
        np.float32)
    f = np.float32
    return Geometry(
        min_x=float(mn[0]), min_y=float(mn[1]),
        sx=float((mx[0] - mn[0]) / f(w - 2.0)),
        sy=float((mx[1] - mn[1]) / f(h - 2.0)),
        z_min=float(mn[2]), z_max=float(mx[2]),
        dz_slab=float((mx[2] - mn[2]) / f(d - 2.0)),
        n0=float(f(1.0) + f(data_min)), w=w, h=h, d=d)


# ---------------------------------------------------------------------------
# The march (ops/march_dense._march_chief, RK4, trilinear)
#
# The state of the rays is one (5, P) tensor (x, y, Tx, Ty, Tz) beside their
# z; a sample gathers its four corners of both slabs at once.  The backward
# is written out: each slab's stages recomputed from its kept entry state,
# then their vector-Jacobian products in reverse, the field's part added
# into the slab pair.  It is what autograd through the same forward gives
# (benchmark/tests/test_bench_reference.py), in a tenth of the launches.
# ---------------------------------------------------------------------------

def _corners(lo, ux, uy):
    """The four corners' flat indices and bilinear weights, clamp-then-hat
    addressing (``march_dense_sampler._two_tap``), and where the clamps
    pass a derivative."""
    h, w, _ = lo.shape
    ucx = torch.nan_to_num(ux, nan=0.0).clamp(0.0, w - 1.0)
    ucy = torch.nan_to_num(uy, nan=0.0).clamp(0.0, h - 1.0)
    ix = ucx.floor().clamp(max=w - 2.0)
    iy = ucy.floor().clamp(max=h - 2.0)
    fx, fy = ucx - ix, ucy - iy
    o00 = (iy * w + ix).long()
    idx = torch.stack([o00, o00 + 1, o00 + w, o00 + w + 1], 1)      # (P, 4)
    wx0, wy0 = 1.0 - fx, 1.0 - fy
    wts = torch.stack([wy0 * wx0, wy0 * fx, fy * wx0, fy * fx], 1)
    passx = ((ux >= 0.0) & (ux <= w - 1.0)).to(ux.dtype)
    passy = ((uy >= 0.0) & (uy <= h - 1.0)).to(uy.dtype)
    return idx, wts, (fx, fy, wx0, wy0, passx, passy)


def slab_sample(lo, hi, ux, uy, uz):
    """(P, 4) (gx, gy, gz, n-1) between two (H, W, 4) slabs."""
    idx, wts, aux = _corners(lo, ux, uy)
    L = lo.reshape(-1, 4)[idx]                                      # (P, 4, 4)
    H = hi.reshape(-1, 4)[idx]
    V = (1.0 - uz)[:, None, None] * L + uz[:, None, None] * H
    return (wts[:, :, None] * V).sum(1), (idx, wts, aux, V, uz)


def _sample_vjp(dc, saved, d_lo, d_hi, w: int):
    """Adds the field's part of ``dc`` (P, 4) into ``d_lo`` / ``d_hi``
    (flat (H W, 4)); returns the coordinates' (d ux, d uy)."""
    idx, wts, (fx, fy, wx0, wy0, passx, passy), V, uz = saved
    tap = wts[:, :, None] * dc[:, None, :]                          # (P, 4, 4)
    flat = idx.reshape(-1)
    d_lo.index_add_(0, flat, ((1.0 - uz)[:, None, None] * tap).reshape(-1, 4))
    d_hi.index_add_(0, flat, (uz[:, None, None] * tap).reshape(-1, 4))
    q = (V * dc[:, None, :]).sum(2)                                 # (P, 4)
    d_fx = (wy0 * (q[:, 1] - q[:, 0]) + fy * (q[:, 3] - q[:, 2]))
    d_fy = (wx0 * (q[:, 2] - q[:, 0]) + fx * (q[:, 3] - q[:, 1]))
    return d_fx * passx, d_fy * passy


def _rhs(lo, hi, g: Geometry, z_plane: float, S, z_at, in_band):
    """The eikonal right-hand side at state S (5, P)."""
    uz = ((z_at - z_plane) / g.dz_slab).clamp(0.0, 1.0)
    ux = 0.5 + (S[0] - g.min_x) / g.sx
    uy = 0.5 + (S[1] - g.min_y) / g.sy
    c, saved = slab_sample(lo, hi, ux, uy, uz)
    inv_tz = 1.0 / torch.where(in_band, S[4], torch.ones_like(S[4]))
    gn = (1.0 + c[:, 3]) * inv_tz
    F = torch.stack([S[2] * inv_tz, S[3] * inv_tz, gn * c[:, 0],
                     gn * c[:, 1], gn * c[:, 2]])
    return F, (saved, c, inv_tz, gn)


def _rhs_vjp(g: Geometry, S, a, aux, in_band, d_lo, d_hi, w: int):
    """(5, P) state cotangent of the right-hand side's cotangent ``a``."""
    saved, c, inv_tz, gn = aux
    s3 = a[2] * c[:, 0] + a[3] * c[:, 1] + a[4] * c[:, 2]
    d_inv = a[0] * S[2] + a[1] * S[3] + s3 * (1.0 + c[:, 3])
    dc = torch.stack([a[2] * gn, a[3] * gn, a[4] * gn, s3 * inv_tz], 1)
    d_ux, d_uy = _sample_vjp(dc, saved, d_lo, d_hi, w)
    zero = torch.zeros_like(d_inv)
    return torch.stack([d_ux / g.sx, d_uy / g.sy, a[0] * inv_tz,
                        a[1] * inv_tz,
                        torch.where(in_band, -d_inv * inv_tz * inv_tz, zero)])


def _stages(lo, hi, g, z_plane, S, z, in_band):
    hh = -(z - z_plane)
    h2 = hh / 2.0
    S1 = S
    F1, a1 = _rhs(lo, hi, g, z_plane, S1, z, in_band)
    S2 = S + h2 * F1
    F2, a2 = _rhs(lo, hi, g, z_plane, S2, z + h2, in_band)
    S3 = S + h2 * F2
    F3, a3 = _rhs(lo, hi, g, z_plane, S3, z + h2, in_band)
    S4 = S + hh * F3
    F4, a4 = _rhs(lo, hi, g, z_plane, S4, z + hh, in_band)
    new = S + (hh / 6.0) * (F1 + 2.0 * F2 + 2.0 * F3 + F4)
    return new, hh, ((S1, a1), (S2, a2), (S3, a3), (S4, a4))


def _slab_step(lo, hi, g: Geometry, z_plane: float, S, z, inside):
    """One slab of the RK4 march: (S, z) -> (S, z) after the slab."""
    in_band = inside & (z > z_plane)
    new, _, _ = _stages(lo, hi, g, z_plane, S, z, in_band)
    return (torch.where(in_band, new, S),
            torch.where(in_band, torch.full_like(z, z_plane), z))


def _slab_vjp(lo, hi, g: Geometry, z_plane: float, S, z, inside, C, d_lo,
              d_hi):
    """The entry state's cotangent of one slab step, given the exit's
    ``C`` (5, P); the field's part added into ``d_lo`` / ``d_hi``."""
    w = lo.shape[1]
    in_band = inside & (z > z_plane)
    _, hh, st = _stages(lo, hi, g, z_plane, S, z, in_band)
    Cm = C * in_band
    dS = Cm.clone()
    dF = [Cm * (hh / 6.0), Cm * (hh / 3.0), Cm * (hh / 3.0), Cm * (hh / 6.0)]
    back = [None, hh / 2.0, hh / 2.0, hh]        # S_k = S + back[k] F_{k-1}
    for k in (3, 2, 1, 0):
        Sk, ak = st[k]
        gk = _rhs_vjp(g, Sk, dF[k], ak, in_band, d_lo, d_hi, w)
        dS = dS + gk
        if k:
            dF[k - 1] = dF[k - 1] + back[k] * gk
    return torch.where(in_band, dS, C)


def _entry(g: Geometry, xs, ys, zs, dcx, dcy, dcz):
    t_entry = (g.z_max - zs) / dcz
    above = zs >= g.z_max
    adv = torch.where(above, t_entry.clamp_min(0.0), torch.zeros_like(zs))
    x = xs + dcx * adv
    y = ys + dcy * adv
    z = torch.where(above, torch.full_like(zs, g.z_max), zs + dcz * adv)
    inside = (z <= g.z_max) & (z >= g.z_min) & (dcz < 0)
    return torch.stack([x, y, g.n0 * dcx, g.n0 * dcy, g.n0 * dcz]), z, inside


def _exit_deltas(S, z, inside, rays):
    """The march's exit state -> the chief deltas of
    ``march_dense.chief_deltas_dense``."""
    xs, ys, zs, dcx, dcy, dcz = rays
    x, y, Tx, Ty, Tz = S.unbind(0)
    Tn = torch.sqrt(Tx * Tx + Ty * Ty + Tz * Tz)
    dx1 = torch.where(inside, Tx / Tn, dcx)
    dy1 = torch.where(inside, Ty / Tn, dcy)
    dz1 = torch.where(inside, Tz / Tn, dcz)
    t = (z - zs) / dcz
    return (z, x - (xs + dcx * t), y - (ys + dcy * t),
            dx1 - dcx, dy1 - dcy, dz1 - dcz)


def march_all(field: torch.Tensor, g: Geometry, rays, kept=None):
    """The march through every slab (differentiable as written); each
    slab's entry state appended to ``kept`` where given."""
    S, z, inside = _entry(g, *rays)
    for s, z_plane in enumerate(g.z_planes()):
        ks = g.d - 2 - s
        if kept is not None:
            kept.append((S, z))
        S, z = _slab_step(field[ks], field[ks + 1], g, z_plane, S, z, inside)
    return S, z, inside


def march_deltas(field: torch.Tensor, g: Geometry, rays, keep: bool = False):
    """Chief deltas of the rays through ``field`` (D, H, W, 4); with
    ``keep`` also what :func:`march_backward` needs."""
    kept = [] if keep else None
    with torch.no_grad():
        S, z, inside = march_all(field, g, rays, kept)
        deltas = _exit_deltas(S, z, inside, rays)
    return deltas, (kept, S, z, inside)


def march_backward(field: torch.Tensor, g: Geometry, rays, tape, d_deltas):
    """The field's gradient of ``sum(d_deltas * deltas)``: the exit's
    derivative by autograd, then the slabs in reverse by hand."""
    kept, S_out, z_out, inside = tape
    with torch.enable_grad():
        S = S_out.detach().requires_grad_(True)
        dl = _exit_deltas(S, z_out, inside, rays)
        (C,) = torch.autograd.grad(dl[1:], S, grad_outputs=d_deltas[1:])
    d_field = torch.zeros_like(field)
    planes = g.z_planes()
    with torch.no_grad():
        for s in range(len(planes) - 1, -1, -1):
            ks = g.d - 2 - s
            Sk, zk = kept[s]
            d_lo = d_field[ks].view(-1, 4)
            d_hi = d_field[ks + 1].view(-1, 4)
            C = _slab_vjp(field[ks], field[ks + 1], g, planes[s], Sk, zk,
                          inside, C, d_lo, d_hi)
    return d_field


# ---------------------------------------------------------------------------
# The fan (ops/fan.py) and the splat (ops/sensor_fast.py)
# ---------------------------------------------------------------------------

def _refract(dx, dy, dz, nx_, ny_, nz_, ratio):
    cos_i = -(dx * nx_ + dy * ny_ + dz * nz_)
    radicand = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    tir = radicand < 0.0
    k = ratio * cos_i - torch.sqrt(radicand.clamp_min(0.0))
    ox = dx * ratio + k * nx_
    oy = dy * ratio + k * ny_
    oz = dz * ratio + k * nz_
    inv = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return ox * inv, oy * inv, oz * inv, tir


def _sphere_hit(cz, radius, dx, dy, dz, px, py, pz):
    ox, oy, oz = px, py, pz - cz
    beta = 2.0 * (dx * ox + dy * oy + dz * oz)
    gamma = ox * ox + oy * oy + oz * oz - radius * radius
    disc = beta * beta - 4.0 * gamma
    miss = disc < 0.0
    sq = torch.sqrt(disc.clamp_min(0.0))
    t1 = (-beta + sq) / 2.0
    t2 = (-beta - sq) / 2.0
    t = torch.minimum(t1, t2) if radius > 0 else torch.maximum(t1, t2)
    return px + dx * t, py + dy * t, pz + dz * t, miss


def _thick_lens(px, py, pz, dx, dy, dz, valid, c: FanConstants):
    hx, hy, hz, miss = _sphere_hit(c.czf, c.r_front, dx, dy, dz, px, py, pz)
    valid = valid & ~miss & (hx * hx + hy * hy <= c.half_pitch_sq)
    nx_, ny_, nz_ = hx, hy, hz - c.czf
    inv = 1.0 / torch.sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_)
    dx, dy, dz, tir = _refract(dx, dy, dz, nx_ * inv, ny_ * inv, nz_ * inv,
                               c.inv_n_lens)
    valid = valid & ~tir
    px, py, pz = hx, hy, hz
    hx, hy, hz, miss = _sphere_hit(c.czb, c.r_back, dx, dy, dz, px, py, pz)
    valid = valid & ~miss & (hx * hx + hy * hy <= c.half_pitch_sq)
    nx_, ny_, nz_ = -hx, -hy, -(hz - c.czb)
    inv = 1.0 / torch.sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_)
    dx, dy, dz, tir = _refract(dx, dy, dz, nx_ * inv, ny_ * inv, nz_ * inv,
                               c.n_lens)
    valid = valid & ~tir
    return hx, hy, hz, dx, dy, dz, valid


def _thin_lens(px, py, pz, dx, dy, dz, valid, c: FanConstants):
    t = (c.z_lens - pz) / dz
    hx, hy = px + dx * t, py + dy * t
    valid = valid & (hx * hx + hy * hy <= c.half_pitch_sq)
    ox = -hx / c.focal_length + dx
    oy = -hy / c.focal_length + dy
    oz = dz
    inv = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return hx, hy, torch.full_like(hx, c.z_lens), \
        ox * inv, oy * inv, oz * inv, valid


def _apply_deltas(deltas, px, py, pz, dx, dy, dz):
    z_exit, dpos_x, dpos_y, ddx, ddy, ddz = (d[:, None] for d in deltas)
    t = (z_exit - pz) / dz
    px = px + dx * t + dpos_x
    py = py + dy * t + dpos_y
    pz = z_exit.expand_as(pz)
    ox = dx + ddx
    oy = dy + ddy
    oz = dz + ddz
    inv = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return px, py, pz, ox * inv, oy * inv, oz * inv


def fan_sums(xs, ys, zs, amp0, deltas, x_lens, y_lens, c: FanConstants,
             lens_model: str):
    """(A, AX, AY) of each particle's fan (``fan_rays`` then ``fan_sums``,
    x mirrored as the diffraction sensor does)."""
    tx = -(x_lens[None, :] - xs[:, None]) / (c.image_distance - zs[:, None])
    ty = -(y_lens[None, :] - ys[:, None]) / (c.image_distance - zs[:, None])
    inv = 1.0 / torch.sqrt(tx * tx + ty * ty + 1.0)
    dx, dy, dz = tx * inv, ty * inv, -inv
    px = xs[:, None].expand_as(tx)
    py = ys[:, None].expand_as(tx)
    pz = zs[:, None].expand_as(tx)
    valid = torch.ones_like(tx, dtype=torch.bool)
    if deltas is not None:
        px, py, pzw, dx, dy, dz = _apply_deltas(deltas, px, py, pz - c.shift,
                                                dx, dy, dz)
        pz = pzw + c.shift
    if lens_model == "apparent":
        rdx, rdy, rdz = -dx, -dy, -dz
        t = (c.z_object - pz) / rdz
        ix = -(px + rdx * t) * c.magnification
        iy = -(py + rdy * t) * c.magnification
        fdx, fdy, fdz = rdx, rdy, rdz
    else:
        lens = _thin_lens if lens_model == "thin-lens" else _thick_lens
        px, py, pz, dx, dy, dz, valid = lens(px, py, pz, dx, dy, dz, valid, c)
        t = (c.z_sensor - pz) / dz
        ix = px + dx * t
        iy = py + dy * t
        fdx, fdy, fdz = dx, dy, dz
    d_x = c.nx_m1 - (ix - c.pixel_1_x) / c.pixel_pitch
    d_y = (iy - c.pixel_1_y) / c.pixel_pitch
    valid = valid & (d_x >= 0) & (d_x < c.nx_f) & (d_y >= 0) & (d_y < c.ny_f)
    cos2 = (fdz * fdz) / (fdx * fdx + fdy * fdy + fdz * fdz)
    X, Y = d_x - 0.5, d_y - 0.5
    zero = torch.zeros_like(cos2)
    amp = torch.where(valid, amp0[:, None] * cos2 * cos2, zero)
    X = torch.where(valid, X, zero)
    Y = torch.where(valid, Y, zero)
    return amp.sum(dim=1), (amp * X).sum(dim=1), (amp * Y).sum(dim=1)


def _erf_pair(f, diameter: float):
    s8 = math.sqrt(8.0)
    return torch.erf(s8 * (f - 0.5) / diameter) \
        - torch.erf(s8 * (f + 0.5) / diameter)


def splat(A, AX, AY, p: Params, patch: int):
    """The image of one erf spot a particle at its ray centroid
    (``render_fast._centroids`` then ``sensor_fast.particle_splat``)."""
    nx, ny, K = p.nx, p.ny, int(patch)
    rf = 1.0 if p.lens_model == "apparent" else 0.75
    D = p.diffraction_diameter
    denom = A.clamp_min(1e-30)
    Xbar, Ybar = AX / denom, AY / denom
    ok = A > 0
    far = torch.full_like(Xbar, -1e6)
    pred_col = torch.round(torch.where(ok, Xbar, far)).to(torch.int32)
    pred_row = torch.round(torch.where(ok, Ybar, far)).to(torch.int32)
    col0 = (pred_col - K // 2).clamp(0, max(nx - K, 0)).to(torch.int32)
    row0 = (pred_row - K // 2).clamp(0, max(ny - K, 0)).to(torch.int32)
    safe = torch.isfinite(Xbar) & torch.isfinite(Ybar) & (A > 0)
    Xs = torch.where(safe, Xbar, torch.full_like(Xbar, -1e6))
    Ys = torch.where(safe, Ybar, torch.full_like(Ybar, -1e6))
    A = torch.where(safe, A, torch.zeros_like(A)) * (math.pi / 32.0)
    ar = torch.arange(K, dtype=torch.int32, device=Xs.device)
    fc = (col0[:, None] + ar[None]).to(Xs.dtype) - Xs[:, None]
    fr = (row0[:, None] + ar[None]).to(Ys.dtype) - Ys[:, None]
    wx = _erf_pair(fc, D)
    wy = _erf_pair(fr, D) * A[:, None]
    patches = wy[:, :, None] * wx[:, None, :]
    rf_d = torch.tensor(rf * D, dtype=torch.float32, device=Xs.device)
    in_circle = (fc[:, None, :] ** 2 + fr[:, :, None] ** 2) <= rf_d * rf_d
    patches = torch.where(in_circle, patches, torch.zeros_like(patches))
    ar64 = torch.arange(K, dtype=torch.int64, device=Xs.device)
    cols = col0.to(torch.int64)[:, None, None] + ar64[None, None, :]
    rows = row0.to(torch.int64)[:, None, None] + ar64[None, :, None]
    inb = (cols >= 0) & (cols < nx) & (rows >= 0) & (rows < ny)
    flat = torch.where(inb, rows * nx + cols, torch.full_like(rows, nx * ny))
    image = torch.zeros(ny * nx + 1, dtype=torch.float32, device=Xs.device)
    image = image.index_add(0, flat.reshape(-1), patches.reshape(-1))
    return image[:ny * nx].reshape(ny, nx)


def auto_patch(p: Params) -> int:
    rf = 1.0 if p.lens_model == "apparent" else 0.75
    return max(6, math.ceil(2.0 * rf * p.diffraction_diameter + 3.0))


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------

@dataclass
class Scene:
    """What the render of one source takes, on the device."""
    p: Params
    c: FanConstants
    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    amp0: torch.Tensor
    x_lens: torch.Tensor
    y_lens: torch.Tensor
    chief: tuple
    patch: int


def scene(cfg, setup, source, r1, r2, dev, scattering=None) -> Scene:
    p = params_of(cfg, setup, source)
    c = fan_constants(p, setup)

    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    xs, ys, zs = f32(source.x), f32(source.y), f32(source.z)
    rad = source.radiance
    if scattering is not None:
        rad = np.asarray(rad, np.float32) * mie_irradiance(
            p.image_distance, source, scattering)
    rad = f32(rad)
    r1, r2 = (torch.as_tensor(r, dtype=torch.float32).to(dev)
              for r in (r1, r2))
    cone = p.ray_cone_pitch_ratio * p.lens_pitch
    x_lens = cone * r1 * torch.cos(2.0 * math.pi * r2)
    y_lens = cone * r1 * torch.sin(2.0 * math.pi * r2)
    if r1.shape[0] == 1:
        x_lens, y_lens = torch.zeros_like(x_lens), torch.zeros_like(y_lens)
    amp_scale = (8.0 / math.pi) / p.aperture_f_number ** 2
    if p.lens_model == "general":
        amp_scale = amp_scale * float(setup.elements.transmission_ratio[0])
    amp0 = rad * float(np.float32(amp_scale))
    # the chief rays toward the lens centre (render_fast._chief_geometry)
    inv_rot = f32(setup.inverse_rotation_matrix)
    shift = float(np.float32(p.z_offset + 750e3))
    dden = p.image_distance - zs
    ctx, cty = xs / dden, ys / dden
    cinv = 1.0 / torch.sqrt(ctx * ctx + cty * cty + 1.0)
    cdir = inv_rot @ torch.stack([ctx * cinv, cty * cinv, -cinv])
    cpos = inv_rot @ torch.stack([xs, ys, zs - shift])
    chief = tuple(t.contiguous() for t in (cpos[0], cpos[1], cpos[2],
                                           cdir[0], cdir[1], cdir[2]))
    return Scene(p, c, xs, ys, zs, amp0, x_lens, y_lens, chief,
                 auto_patch(p))


def image_of(sc: Scene, deltas, chunk: int = 10000,
             lowp: Lowp = None) -> torch.Tensor:
    """The raw image from the chief deltas (None: no volume)."""
    P = sc.xs.shape[0]
    img = torch.zeros((sc.p.ny, sc.p.nx), dtype=torch.float32,
                      device=sc.xs.device)
    with torch.no_grad():
        for s in range(0, P, chunk):
            sl = slice(s, min(P, s + chunk))
            d6 = None if deltas is None else tuple(d[sl] for d in deltas)
            sums = fan_sums(sc.xs[sl], sc.ys[sl], sc.zs[sl], sc.amp0[sl], d6,
                            sc.x_lens, sc.y_lens, sc.c, sc.p.lens_model)
            img += splat(*sums, sc.p, sc.patch)
    return _round(img, lowp)


def deltas_backward(sc: Scene, deltas, d_img: torch.Tensor,
                    chunk: int = 10000):
    """The deltas' gradient of ``sum(d_img * image_of(deltas))``, a chunk
    of particles at a time."""
    P = sc.xs.shape[0]
    out = [torch.zeros_like(d) for d in deltas]
    for s in range(0, P, chunk):
        sl = slice(s, min(P, s + chunk))
        with torch.enable_grad():
            d6 = [d[sl].detach().requires_grad_(True) for d in deltas]
            sums = fan_sums(sc.xs[sl], sc.ys[sl], sc.zs[sl], sc.amp0[sl], d6,
                            sc.x_lens, sc.y_lens, sc.c, sc.p.lens_model)
            img = splat(*sums, sc.p, sc.patch)
            grads = torch.autograd.grad(img, d6, grad_outputs=d_img)
        for o, g in zip(out, grads):
            o[sl] = g
    return tuple(out)


def render(sc: Scene, field: Optional[torch.Tensor], g: Optional[Geometry],
           lowp: Lowp = None) -> torch.Tensor:
    """The raw image of the scene through ``field`` (None: no volume)."""
    deltas = None
    if field is not None:
        deltas, _ = march_deltas(_round(field, lowp), g, sc.chief)
    return image_of(sc, deltas, lowp=lowp)
