"""Per-particle ray-fan statistics: kernel wrappers and plain version.

Kernels: ``csrc/fan_stats.cu`` (``photon_fan_stats``) replaces the TPU
kernel ``photon_tpu/ops/fan_pallas.py::_fan_fwd_kernel`` (tile math
``_fan_tile``) and ``csrc/fan_stats_bwd.cu`` (``photon_fan_stats_bwd``)
replaces ``_fan_bwd_kernel``.  For each (particle, ray) it generates the ray toward its
lens-aperture sample, applies the chief-ray march deltas, runs the
apparent / thin / thick lens, intersects the sensor (x mirrored on the
diffraction path), masks rays that leave the aperture or the sensor and
weighs by cos^4; per particle it returns

    A  = sum_r amp,   AX = sum_r amp * X,   AY = sum_r amp * Y

which is all the per-particle erf splat consumes.  Bound on the card: f32
operations (a few hundred per pair, with square roots and divisions)
against 40 bytes a particle and 8 bytes a ray of input; no (P, R) array
exists.  One warp owns a particle, its lanes stride over its rays and
reduce with shuffles: no atomics, so the sums are the same from run to run.
Both kernels divide by the pixel pitch, the focal length and a particle's
distance to the image plane with a correctly rounded reciprocal and one
correction (``csrc/div_rn.cuh``; the division's bits on every divisor of
the bench scene, for every numerator: ``tests/test_torch_division.py``);
:func:`f32_reciprocal` forms the first two.

The plain version is the (P, R) structure-of-arrays chain of the JAX
package's ``models/render_fast.py::render_chunk`` with its lens stages
(``propagate_thick_lens_soa``, ``propagate_thin_lens_soa``,
``_refract_soa``, ``_sphere_hit_soa``); its ray path, :func:`fan_rays`,
also serves the renderer's per-ray chain (``models/render_fast.py``), where
the fan kernel does not apply.  Both versions take reciprocal
square roots as ``1 / sqrt`` and form the scalar constants once, in
float64, before rounding to float32 (:func:`fan_constants`).

The backward kernel returns the cotangents of the ten per-particle columns
``[xs, ys, zs, amp0, dz_exit, dpx, dpy, ddx, ddy, ddz]``: a hand-derived
reverse sweep of the same chain, one block a particle, reduced with
shuffles.  It multiplies by reciprocals where the forward divides by the
pixel pitch and the focal length: :func:`fan_backward_constants` forms them
in float64.  No kernel computes cotangents of the lens rows ``x_lens`` /
``y_lens``: on the card they must not require grad (detach them); the TPU
kernel returns zeros for them instead.  The plain version of the backward is
``torch.autograd`` through :func:`fan_stats_plain`.

``fan_stats.launches`` and ``fan_stats_backward.launches`` count kernel
launches.
"""
from __future__ import annotations

import functools
from fractions import Fraction
from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch import kernels
from photon_tpu_torch.ops.march_fast import apply_chief_deltas

LENS_MODELS = ("apparent", "thin-lens", "general")


class FanScalars(NamedTuple):
    """Scalar configuration of the fan chain."""
    image_distance: float
    shift: float                 # z_offset + 750e3 (march frame)
    # apparent
    z_object: float
    magnification: float
    # thin / thick
    z_lens: float
    pitch: float
    focal_length: float
    vertex: float
    r_front: float
    r_back: float
    n_lens: float
    # sensor
    nx: int
    ny: int
    pixel_pitch: float
    z_sensor: float


class FanConstants(NamedTuple):
    """Derived constants in the order of the kernel's ``FanConst`` struct."""
    image_distance: float
    shift: float
    z_object: float
    magnification: float
    z_lens: float
    half_pitch_sq: float
    focal_length: float
    czf: float                   # centre of the front sphere
    r_front: float
    czb: float                   # centre of the back sphere
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
    inv_pixel_pitch: float       # f32_reciprocal(pixel_pitch)
    inv_focal_length: float      # f32_reciprocal(focal_length)


@functools.lru_cache(maxsize=64)
def f32_reciprocal(x: float) -> float:
    """The float32 nearest to 1 / float32(x), the reciprocal with which
    the kernels divide by ``x`` (``csrc/div_rn.cuh`` needs it correctly
    rounded); IEEE division gives it, exact arithmetic checks it.  Cached:
    the check takes tens of microseconds and every launch asks."""
    b = np.float32(x)
    with np.errstate(divide="ignore", over="ignore"):
        r = np.float32(1.0) / b
    if not (np.isfinite(b) and np.isfinite(r) and b != 0):
        return float(r)          # no quotient of the kernels can use it
    exact = 1 / Fraction(float(b))
    miss = abs(Fraction(float(r)) - exact)
    for nb in (np.nextafter(r, np.float32(-np.inf)),
               np.nextafter(r, np.float32(np.inf))):
        if abs(Fraction(float(nb)) - exact) < miss:
            raise ArithmeticError(f"1 / {b} rounded to {r}, not to {nb}")
    return float(r)


def fan_constants(sc: FanScalars) -> FanConstants:
    half_pitch = sc.pitch / 2.0
    return FanConstants(
        image_distance=sc.image_distance, shift=sc.shift,
        z_object=sc.z_object, magnification=sc.magnification,
        z_lens=sc.z_lens, half_pitch_sq=half_pitch * half_pitch,
        focal_length=sc.focal_length,
        czf=sc.z_lens + sc.vertex / 2.0 - sc.r_front, r_front=sc.r_front,
        czb=sc.z_lens - sc.vertex / 2.0 - sc.r_back, r_back=sc.r_back,
        n_lens=sc.n_lens, inv_n_lens=1.0 / sc.n_lens,
        z_sensor=sc.z_sensor, pixel_pitch=sc.pixel_pitch,
        pixel_1_x=-sc.pixel_pitch * (sc.nx - 1) / 2.0,
        pixel_1_y=-sc.pixel_pitch * (sc.ny - 1) / 2.0,
        nx_f=float(sc.nx), ny_f=float(sc.ny), nx_m1=float(sc.nx - 1),
        inv_pixel_pitch=f32_reciprocal(sc.pixel_pitch),
        inv_focal_length=f32_reciprocal(sc.focal_length))


def fan_backward_constants(sc: FanScalars) -> np.ndarray:
    """The backward kernel's constants (its ``FanBwdConst`` struct): those
    of :func:`fan_constants`, then ``1 / pixel_pitch`` and
    ``1 / focal_length``, all formed in float64 and rounded once to
    float32."""
    c = fan_constants(sc)
    return np.asarray(tuple(c) + (1.0 / c.pixel_pitch, 1.0 / c.focal_length),
                      dtype=np.float64).astype(np.float32)


FAN_BWD_CONST_FLOATS = len(FanConstants._fields) + 2


# ---------------------------------------------------------------------------
# Plain lens stages on (P, R) component arrays
# ---------------------------------------------------------------------------


def _refract_soa(dx, dy, dz, nx_, ny_, nz_, ratio):
    """Snell refraction, componentwise."""
    cos_i = -(dx * nx_ + dy * ny_ + dz * nz_)
    radicand = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    tir = radicand < 0.0
    k = ratio * cos_i - torch.sqrt(radicand.clamp_min(0.0))
    ox = dx * ratio + k * nx_
    oy = dy * ratio + k * ny_
    oz = dz * ratio + k * nz_
    inv = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return ox * inv, oy * inv, oz * inv, tir


def _sphere_hit_soa(cz, radius, dx, dy, dz, px, py, pz):
    """First intersection with the sphere centred (0, 0, cz); the root is
    the nearer one for a positive radius, the farther for a negative."""
    ox, oy, oz = px, py, pz - cz
    beta = 2.0 * (dx * ox + dy * oy + dz * oz)
    gamma = ox * ox + oy * oy + oz * oz - radius * radius
    disc = beta * beta - 4.0 * gamma          # alpha == 1 for unit dirs
    miss = disc < 0.0
    sq = torch.sqrt(disc.clamp_min(0.0))
    t1 = (-beta + sq) / 2.0
    t2 = (-beta - sq) / 2.0
    t = torch.minimum(t1, t2) if radius > 0 else torch.maximum(t1, t2)
    return px + dx * t, py + dy * t, pz + dz * t, miss


def propagate_thick_lens_soa(px, py, pz, dx, dy, dz, valid, c: FanConstants):
    """Biconvex thick lens on the z axis (math: parallel_ray_tracing.cu
    :507-864), for the axis-aligned single-lens train."""
    hx, hy, hz, miss = _sphere_hit_soa(c.czf, c.r_front, dx, dy, dz,
                                       px, py, pz)
    valid = valid & ~miss & (hx * hx + hy * hy <= c.half_pitch_sq)
    nx_, ny_, nz_ = hx, hy, hz - c.czf
    inv = 1.0 / torch.sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_)
    dx, dy, dz, tir = _refract_soa(dx, dy, dz, nx_ * inv, ny_ * inv,
                                   nz_ * inv, c.inv_n_lens)
    valid = valid & ~tir
    px, py, pz = hx, hy, hz

    hx, hy, hz, miss = _sphere_hit_soa(c.czb, c.r_back, dx, dy, dz,
                                       px, py, pz)
    valid = valid & ~miss & (hx * hx + hy * hy <= c.half_pitch_sq)
    nx_, ny_, nz_ = -hx, -hy, -(hz - c.czb)
    inv = 1.0 / torch.sqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_)
    dx, dy, dz, tir = _refract_soa(dx, dy, dz, nx_ * inv, ny_ * inv,
                                   nz_ * inv, c.n_lens)
    valid = valid & ~tir
    return hx, hy, hz, dx, dy, dz, valid


def propagate_thin_lens_soa(px, py, pz, dx, dy, dz, valid, c: FanConstants):
    """Ideal thin lens at z_lens (ref: :416-503)."""
    t = (c.z_lens - pz) / dz
    hx, hy = px + dx * t, py + dy * t
    valid = valid & (hx * hx + hy * hy <= c.half_pitch_sq)
    ox = -hx / c.focal_length + dx
    oy = -hy / c.focal_length + dy
    oz = dz
    inv = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return hx, hy, torch.full_like(hx, c.z_lens), \
        ox * inv, oy * inv, oz * inv, valid


def fan_rays(xs, ys, zs, x_lens, y_lens, c: FanConstants, lens_model: str,
             mirror_x: bool, march=None, sensor_noise=None):
    """Every ray of the (P, R) fans from source to sensor, plain PyTorch.

    Generates the ray from each particle toward each lens-aperture sample,
    passes the camera-frame rays through ``march`` (a function of the six
    (P, R) components that returns them after the volume, or None), runs
    the lens, adds ``sensor_noise`` ((2, P, R) displacements, or None) to
    the sensor-plane intersection and maps it to pixels (x mirrored when
    ``mirror_x``).  Returns ``(X, Y, cos2, valid)``, each (P, R): the pixel
    coordinates ``d_x - 0.5`` / ``d_y - 0.5`` (not finite for some culled
    rays), the squared cosine of the ray to the sensor normal, and the rays
    that pass the aperture and land on the sensor."""
    tx = -(x_lens[None, :] - xs[:, None]) / (c.image_distance - zs[:, None])
    ty = -(y_lens[None, :] - ys[:, None]) / (c.image_distance - zs[:, None])
    inv = 1.0 / torch.sqrt(tx * tx + ty * ty + 1.0)
    dx, dy, dz = tx * inv, ty * inv, -inv
    px = xs[:, None].expand_as(tx)
    py = ys[:, None].expand_as(tx)
    pz = zs[:, None].expand_as(tx)
    valid = torch.ones_like(tx, dtype=torch.bool)

    if march is not None:
        px, py, pz, dx, dy, dz = march(px, py, pz, dx, dy, dz)

    if lens_model == "apparent":
        # reverse + object-plane intersection + magnification
        # (ref: create_apparent_image :1545-1648)
        rdx, rdy, rdz = -dx, -dy, -dz
        t = (c.z_object - pz) / rdz
        ix = -(px + rdx * t) * c.magnification
        iy = -(py + rdy * t) * c.magnification
        fdx, fdy, fdz = rdx, rdy, rdz
    else:
        if lens_model == "thin-lens":
            px, py, pz, dx, dy, dz, valid = propagate_thin_lens_soa(
                px, py, pz, dx, dy, dz, valid, c)
        else:
            px, py, pz, dx, dy, dz, valid = propagate_thick_lens_soa(
                px, py, pz, dx, dy, dz, valid, c)
        t = (c.z_sensor - pz) / dz
        ix = px + dx * t
        iy = py + dy * t
        fdx, fdy, fdz = dx, dy, dz

    # per-ray sensor position noise, on the intersection before the pixel
    # mapping (ref: :1424-1434)
    if sensor_noise is not None:
        ix = ix + sensor_noise[0]
        iy = iy + sensor_noise[1]

    # pixel coordinates (the diffraction path mirrors x, ref: :1441-1447;
    # the bilinear path does not, ref: :1814)
    d_x = (ix - c.pixel_1_x) / c.pixel_pitch
    if mirror_x:
        d_x = c.nx_m1 - d_x
    d_y = (iy - c.pixel_1_y) / c.pixel_pitch
    on_sensor = (d_x >= 0) & (d_x < c.nx_f) & (d_y >= 0) & (d_y < c.ny_f)
    valid = valid & on_sensor

    cos2 = (fdz * fdz) / (fdx * fdx + fdy * fdy + fdz * fdz)
    return d_x - 0.5, d_y - 0.5, cos2, valid


def fan_sums(X, Y, cos2, valid, amp0):
    """Per-ray amplitudes ``amp0 * cos^4`` (zero for culled rays) and the
    per-particle sums ``(A, AX, AY)`` of :func:`fan_rays`' rays."""
    zero = torch.zeros_like(cos2)
    amp = torch.where(valid, amp0[:, None] * cos2 * cos2, zero)
    # X/Y of culled rays are zeroed under the same mask as amp, so that
    # 0 * inf never reaches the sums
    X = torch.where(valid, X, zero)
    Y = torch.where(valid, Y, zero)
    return amp, (amp.sum(dim=1), (amp * X).sum(dim=1), (amp * Y).sum(dim=1))


def _fan_chunk_plain(xs, ys, zs, amp0, deltas6, x_lens, y_lens,
                     c: FanConstants, lens_model: str, mirror_x: bool):
    march = None
    if deltas6 is not None:
        def march(px, py, pz, dx, dy, dz):
            # camera -> march frame (z shift only: unrotated camera), chief
            # deltas, back to the camera frame
            px, py, pzw, dx, dy, dz = apply_chief_deltas(
                deltas6, px, py, pz - c.shift, dx, dy, dz)
            return px, py, pzw + c.shift, dx, dy, dz

    rays = fan_rays(xs, ys, zs, x_lens, y_lens, c, lens_model, mirror_x,
                    march=march)
    return fan_sums(*rays, amp0)[1]


def fan_stats_plain(xs, ys, zs, amp0, deltas6, x_lens, y_lens, *,
                    sc: FanScalars, lens_model: str, mirror_x: bool = True,
                    particles_per_chunk: Optional[int] = None):
    """Plain PyTorch fan statistics on (P, R) arrays, on any device.

    ``particles_per_chunk`` bounds the (P, R) intermediates (the chain
    holds dozens of them at once)."""
    if lens_model not in LENS_MODELS:
        raise ValueError(f"unknown lens_model {lens_model!r}")
    c = fan_constants(sc)
    P = xs.shape[0]
    pc = P if not particles_per_chunk else int(particles_per_chunk)
    if pc >= P:
        return _fan_chunk_plain(xs, ys, zs, amp0, deltas6, x_lens, y_lens,
                                c, lens_model, bool(mirror_x))
    parts = []
    for s in range(0, P, pc):
        sl = slice(s, s + pc)
        d6 = None if deltas6 is None else tuple(d[sl] for d in deltas6)
        parts.append(_fan_chunk_plain(xs[sl], ys[sl], zs[sl], amp0[sl], d6,
                                      x_lens, y_lens, c, lens_model,
                                      bool(mirror_x)))
    return tuple(torch.cat(col) for col in zip(*parts))


def _launch_args(cols, x_lens, y_lens):
    """Pointers of the four columns, the six deltas (null without a march)
    and the two lens rows, in the kernels' order."""
    ptrs = [c.data_ptr() for c in cols[:4]]
    ptrs += [None] * 6 if len(cols) == 4 else [c.data_ptr() for c in cols[4:]]
    return ptrs + [x_lens.data_ptr(), y_lens.data_ptr()]


def fan_stats_backward(cols, x_lens, y_lens, ct, consts, lens_model: str,
                       mirror_x: bool):
    """Launch the backward kernel: (10, P) cotangents of the columns (the
    six delta rows are zero without a march) from ``ct`` (3, P);
    ``consts`` from :func:`fan_backward_constants`."""
    dev = ct.device
    P, R = cols[0].shape[0], x_lens.shape[0]
    if len(cols) not in (4, 10):
        raise ValueError("cols must hold 4 columns, or 10 with the deltas")
    for name, t, shape in [("ct", ct, (3, P)), ("x_lens", x_lens, (R,)),
                           ("y_lens", y_lens, (R,))] \
            + [(f"cols[{i}]", c, (P,)) for i, c in enumerate(cols)]:
        kernels.check_kernel_input(name, t, dev, torch.float32)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if consts.dtype != np.float32 or consts.shape != (FAN_BWD_CONST_FLOATS,):
        raise ValueError(f"consts: expected the {FAN_BWD_CONST_FLOATS} "
                         f"float32 values of fan_backward_constants, got "
                         f"{consts.dtype} {consts.shape}")
    d_cols = torch.empty((10, P), dtype=torch.float32, device=dev)
    lib = kernels.load("fan_stats_bwd")
    if lib.photon_fan_bwd_const_floats() != consts.size:
        raise RuntimeError("fan_backward_constants and the kernel's "
                           "FanBwdConst differ")
    with torch.cuda.device(dev):
        code = lib.photon_fan_stats_bwd(
            *_launch_args(cols, x_lens, y_lens), ct.data_ptr(),
            d_cols.data_ptr(), P, R, consts.ctypes.data,
            LENS_MODELS.index(lens_model), int(len(cols) == 10),
            int(bool(mirror_x)), kernels.current_stream(dev))
    kernels.check_launch(code, "photon_fan_stats_bwd")
    fan_stats_backward.launches += 1
    return d_cols


fan_stats_backward.launches = 0


class _FanStats(torch.autograd.Function):
    """(3, P) fan statistics on the card from 4 or 10 per-particle columns."""

    @staticmethod
    def forward(ctx, x_lens, y_lens, sc, lens_model, mirror_x, *cols):
        dev = x_lens.device
        P, R = cols[0].shape[0], x_lens.shape[0]
        consts = np.asarray(fan_constants(sc), dtype=np.float32)
        out = torch.empty((3, P), dtype=torch.float32, device=dev)
        lib = kernels.load("fan_stats")
        if lib.photon_fan_const_floats() != consts.size:
            raise RuntimeError("FanConstants and the kernel's FanConst differ")
        with torch.cuda.device(dev):
            code = lib.photon_fan_stats(
                *_launch_args(cols, x_lens, y_lens), out.data_ptr(), P, R,
                consts.ctypes.data, LENS_MODELS.index(lens_model),
                int(len(cols) == 10), int(bool(mirror_x)),
                kernels.current_stream(dev))
        kernels.check_launch(code, "photon_fan_stats")
        fan_stats.launches += 1
        ctx.sc, ctx.lens_model, ctx.mirror_x = sc, lens_model, mirror_x
        ctx.save_for_backward(x_lens, y_lens, *cols)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        x_lens, y_lens, *cols = ctx.saved_tensors
        d_cols = fan_stats_backward(cols, x_lens, y_lens, ct.contiguous(),
                                    fan_backward_constants(ctx.sc),
                                    ctx.lens_model, ctx.mirror_x)
        return (None,) * 5 + tuple(d_cols[:len(cols)].unbind(0))


def fan_stats(xs, ys, zs, amp0, deltas6, x_lens, y_lens, *,
              sc: FanScalars, lens_model: str, mirror_x: bool = True):
    """Per-particle fan statistics (A, AX, AY), each (P,).

    ``amp0``: per-particle amplitude with all scalar factors folded
    (radiance / f#^2 * transmission * 8/pi).  ``deltas6``: the six (P,)
    chief-march deltas or None.  ``x_lens``/``y_lens``: (R,) lens-aperture
    sample offsets (R == 1 must pass zeros — the caller's quirk).

    Tensors on a CUDA device go to the kernels, forward and backward;
    tensors on the CPU go to the plain version and ``torch.autograd`` through
    it.  On the card gradients flow to the particle columns and the deltas;
    lens rows that require grad raise.
    """
    if lens_model not in LENS_MODELS:
        raise ValueError(f"unknown lens_model {lens_model!r}")
    dev = xs.device
    cols = {"xs": xs, "ys": ys, "zs": zs, "amp0": amp0}
    if deltas6 is not None:
        if len(deltas6) != 6:
            raise ValueError("deltas6 must hold six (P,) tensors")
        cols.update({f"deltas6[{i}]": d for i, d in enumerate(deltas6)})
    for name, t in cols.items():
        kernels.check_kernel_input(name, t, dev, torch.float32)
        if t.shape != xs.shape or t.dim() != 1:
            raise ValueError(f"{name}: expected shape {tuple(xs.shape)}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("x_lens", x_lens), ("y_lens", y_lens)):
        kernels.check_kernel_input(name, t, dev, torch.float32)
        if t.shape != x_lens.shape or t.dim() != 1:
            raise ValueError(f"{name}: expected a (R,) tensor")
    if dev.type == "cpu":
        return fan_stats_plain(xs, ys, zs, amp0, deltas6, x_lens, y_lens,
                               sc=sc, lens_model=lens_model,
                               mirror_x=mirror_x)
    if torch.is_grad_enabled() and (x_lens.requires_grad
                                    or y_lens.requires_grad):
        raise ValueError(
            "x_lens / y_lens require grad: the fan backward kernel returns "
            "cotangents of the per-particle columns only; detach the lens "
            "rows")
    if xs.shape[0] == 0:
        return tuple(torch.empty((3, 0), dtype=torch.float32,
                                 device=dev).unbind(0))
    out = _FanStats.apply(x_lens, y_lens, sc, lens_model, bool(mirror_x),
                          *cols.values())
    return tuple(out.unbind(0))


fan_stats.launches = 0
