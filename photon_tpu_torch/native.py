"""Volume preparation: the gradient precompute, the cubic B-spline
prefilter and its transpose, and the NRRD header probe.

Counterpart of ``photon_tpu/native/`` (``photon_native.cpp`` and its ctypes
bindings), the JAX package's host C++ module.  There these run on the host
before the arrays go to the TPU; here each numerical one is a plain PyTorch
version, which a tensor on the CPU gets, and a CUDA kernel of
``csrc/volume_prep.cu``, which a tensor on a CUDA device gets (no TPU
kernel stands behind them).  Both live in this module, which imports no
other of the port but ``kernels`` and ``utils.profiling``; ``volume`` and
``ops/march_dense`` take them from here.

* K10 ``photon_gradient_field`` (native ``gradient_field``): the packed
  (dn/dx, dn/dy, dn/dz, n-1) field, (D, H, W, 4), from float32 n-1 in the
  NRRD's (W, H, D) layout, in double, rounded once, an x-z tile a block
  on the grid of :func:`gradient_plan`.  Plain version:
  :func:`gradient_field_plain` (torch float64 over :func:`grad_axis`),
  bit-equal on the CPU.
* K13 ``photon_gradient_field_transpose``: K10's transpose, the
  backward of ``inverse.volume_from_rho`` on the card: the (D, H, W, 4)
  cotangent of the packed field -> the (W, H, D) cotangent of rho, times
  the Gladstone-Dale constant, in double, rounded once, on K10's grid.
  Plain version: :func:`gradient_field_transpose_plain` (torch float64 over
  :func:`grad_axis_transpose`).  No counterpart in the JAX package, whose
  ``volume_from_rho`` leaves the transpose to XLA's autodiff.
* K11 ``photon_bspline_prefilter`` (native ``bspline_prefilter_3d``; what
  the JAX fast path runs is ``ops/march_dense.py::bspline_prefilter_jax``):
  cubic B-spline coefficients of a (D, H, W, C) float32 field.  Plain
  version: :func:`bspline_prefilter_plain`, the recurrence
  :func:`_prefilter_axis` along each axis; both take their float32
  constants from :func:`prefilter_constants`.
* K12 ``photon_bspline_prefilter_bwd``: K11's transpose, the backward of
  :class:`_BSplinePrefilter`.  Plain version: ``torch.autograd`` through
  the plain prefilter.

:func:`gradient_field`, :func:`gradient_field_transpose` and
:func:`bspline_prefilter` send a tensor on the CPU to the plain version and
a tensor on a CUDA device to the kernel; the launchers refuse what the
kernels do not take before any build, and raise if a launch fails.
``launch_gradient_field.launches`` and
``launch_gradient_field_transpose.launches`` count the launcher calls, one
kernel launch each; ``launch_prefilter.launches`` and
``launch_prefilter_bwd.launches`` count kernel launches, three a call (one
an axis), so that a trace's launches of K11 and K12 can be held to them.
On the card K11 runs inside the span ``prefilter.coefficients`` and K12
inside ``prefilter.transpose`` (``utils.profiling.span``: a
``torch.profiler`` range while a profiler runs, one boolean test
otherwise).

Not carried over from the JAX package: ``available()``, ``build()`` and
their contract that a missing library returns None so that the caller falls
back to numpy.  Under the port's device rule the kernels build at first
launch (``kernels.py``) and a failed build raises.  :func:`nrrd_probe`
needs no library: it is Python with native's return contract.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import NamedTuple

import numpy as np
import torch

from photon_tpu_torch import kernels
from photon_tpu_torch.utils.profiling import span

# ---------------------------------------------------------------------------
# K10: the gradient precompute
# ---------------------------------------------------------------------------


def grad_axis(f: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """Derivative along one axis: central differences inside, second-order
    one-sided at the faces, in ``f``'s dtype (the stencils of the
    reference's ``setData``, ref: trace_rays_through_density_gradients.h
    :1856-1995)."""
    n = f.shape[axis]
    take = lambda i: f.narrow(axis, i, 1)  # noqa: E731
    lo = (-1.5 * take(0) + 2.0 * take(1) - 0.5 * take(2)) / h
    interior = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) \
        / (2.0 * h)
    hi = (1.5 * take(n - 1) - 2.0 * take(n - 2) + 0.5 * take(n - 3)) / h
    return torch.cat([lo, interior, hi], dim=axis)


def gradient_field_plain(n_minus_1, spacing) -> torch.Tensor:
    """The plain version of K10: each axis's :func:`grad_axis` in float64,
    then one rounding to float32; on the CPU bit-equal to the JAX package's
    native ``gradient_field`` (and its numpy fallback) on float32 input.

    Args:
      n_minus_1: (W, H, D) tensor or array indexed [x, y, z] (NRRD axis
        order); a tensor stays on its device.
      spacing: (3,) grid spacings (dx, dy, dz).

    Returns:
      (D, H, W, 4) float32 packed (dn/dx, dn/dy, dn/dz, n-1), [z, y, x].
    """
    f = torch.as_tensor(n_minus_1).to(torch.float64)
    w, h, d = f.shape
    if min(w, h, d) < 3:
        raise ValueError(f"n_minus_1: every axis needs >= 3 samples, got "
                         f"{tuple(f.shape)}")
    dx, dy, dz = (float(s) for s in np.asarray(spacing).ravel())
    packed = torch.stack([grad_axis(f, 0, dx), grad_axis(f, 1, dy),
                          grad_axis(f, 2, dz), f], dim=-1)   # (W, H, D, 4)
    return packed.permute(2, 1, 0, 3).to(torch.float32).contiguous()


# K10's grid (csrc/volume_prep.cu, gradient_tile_kernel): a block owns an
# x-z tile of GRADIENT_TILE x GRADIENT_TILE voxels and a run of y planes.
# A run is at most GRADIENT_MAX_RUN planes, and shorter where the grid
# would otherwise hold fewer than GRADIENT_BLOCKS blocks: two waves at four
# blocks an SM on an H100's 132 SMs.  Long runs read fewer planes twice (a
# run reads the planes its stencils reach, y0 - 1 .. y1); many blocks fill
# the SMs and leave a short last wave.  The SM count is a constant, not
# read from the device, so that the grid follows from the shape alone: the
# CPU tests check the grid the card runs, and GRADIENT_EDGE_SHAPES reach
# its last runs of one and two planes.  On a card with other SM counts the
# grid stays right and only its waves fill differently.
GRADIENT_TILE = 32
GRADIENT_MAX_RUN = 16
GRADIENT_BLOCKS = 8 * 132
# a tile's samples along x or z with the stencils' halo (kGradSpan), and
# the floats of a staging row of 16-byte copies (kGradStagePitch)
GRADIENT_SPAN = GRADIENT_TILE + 2
GRADIENT_STAGE_PITCH = GRADIENT_TILE + 8

# (W, H, D) that reach every edge of K10's tiles and y runs on the grid of
# gradient_plan, on which the card test of K10 and chip_smoke.py hold it
# bit for bit: every axis 3; axes of 3 and 4 with W and D at 32k + 1 and
# 32k + 2 (a last tile of one or two columns, which reads two columns
# below it); D a multiple of 4 (16-byte copies) and not; y runs of 4 with a
# last run of one and of two planes ((33, 793, 34), (33, 794, 34)) and of 2
# and 3 with the same ((3, 1057, 3), (3, 2114, 3)).
GRADIENT_EDGE_SHAPES = [(3, 5, 4), (17, 9, 33), (3, 3, 3), (33, 5, 34),
                        (65, 7, 66), (34, 3, 65), (66, 4, 33), (65, 6, 96),
                        (33, 793, 34), (33, 794, 34), (3, 1057, 3),
                        (3, 2114, 3)]


def gradient_reach(a: int, b: int, n: int) -> tuple:
    """The first and the last sample that K10's stencils of indices a ..
    b - 1 along an axis of n >= 3 read (the kernel's reach_lo(a, n) and
    reach_hi(b, n))."""
    return max(0, min(a - 1, n - 3)), min(max(b, 2), n - 1)


def gradient_spans(n: int, count: int, width: int) -> list:
    """[(i0, i1, lo, hi)] for each of `count` tiles or y runs of `width`
    along an axis of n: the indices i0 .. i1 - 1 its block computes and the
    samples lo .. hi (:func:`gradient_reach`) that it copies in."""
    out = []
    for t in range(count):
        i0, i1 = t * width, min(n, t * width + width)
        out.append((i0, i1, *gradient_reach(i0, i1, n)))
    return out


class GradientPlan(NamedTuple):
    """K10's grid for a (W, H, D) input: ``tiles_x`` x ``tiles_z`` x-z
    tiles of ``GRADIENT_TILE`` voxels, y runs of ``y_run`` planes
    (``runs`` of them), ``blocks`` in all; block b takes z tile
    b % tiles_z, x tile (b // tiles_z) % tiles_x and y run
    b // (tiles_z tiles_x)."""
    tiles_x: int
    tiles_z: int
    y_run: int
    runs: int
    blocks: int


@functools.lru_cache(maxsize=16)
def gradient_plan(w: int, h: int, d: int) -> GradientPlan:
    """K10's grid from the input's shape alone (:class:`GradientPlan`)."""
    tiles_x, tiles_z = -(-w // GRADIENT_TILE), -(-d // GRADIENT_TILE)
    want_runs = -(-GRADIENT_BLOCKS // (tiles_x * tiles_z))
    y_run = min(GRADIENT_MAX_RUN, -(-h // want_runs))
    runs = -(-h // y_run)
    return GradientPlan(tiles_x, tiles_z, y_run, runs,
                        tiles_x * tiles_z * runs)


def launch_gradient_field(n_minus_1: torch.Tensor, spacing) -> torch.Tensor:
    """Launch K10: (W, H, D) float32 n-1 on a CUDA device -> the packed
    (D, H, W, 4) float32 field, on the grid of :func:`gradient_plan`."""
    kernels.check_kernel_input("n_minus_1", n_minus_1, None, torch.float32)
    if n_minus_1.dim() != 3 or min(n_minus_1.shape) < 3:
        raise ValueError(f"n_minus_1: expected (W, H, D) with every axis >= "
                         f"3, got {tuple(n_minus_1.shape)}")
    dx, dy, dz = (float(s) for s in np.asarray(spacing).ravel())
    w, h, d = (int(n) for n in n_minus_1.shape)
    out = torch.empty((d, h, w, 4), dtype=torch.float32,
                      device=n_minus_1.device)
    plan = gradient_plan(w, h, d)
    lib = kernels.load("volume_prep")
    with torch.cuda.device(n_minus_1.device):
        code = lib.photon_gradient_field(
            n_minus_1.data_ptr(), out.data_ptr(), w, h, d, dx, dy, dz,
            plan.y_run, kernels.current_stream(n_minus_1.device))
    kernels.check_launch(code, "photon_gradient_field")
    launch_gradient_field.launches += 1
    return out


launch_gradient_field.launches = 0


def gradient_field(n_minus_1: torch.Tensor, spacing) -> torch.Tensor:
    """Finite-difference gradient of n-1 packed with its values: (W, H, D)
    float32 [x, y, z] -> (D, H, W, 4) float32 [z, y, x] on the same device:
    :func:`gradient_field_plain` on the CPU, K10 on a CUDA device."""
    if n_minus_1.device.type == "cpu":
        return gradient_field_plain(n_minus_1, spacing)
    return launch_gradient_field(n_minus_1.contiguous(), spacing)


# ---------------------------------------------------------------------------
# K13: the gradient precompute's transpose
# ---------------------------------------------------------------------------

# K13 (csrc/volume_prep.cu, gradient_transpose_kernel) runs on K10's grid
# (gradient_plan); its tiles read a wider halo than K10's, whose size
# along x or z (kTrSpan) this is
GRADIENT_TRANSPOSE_SPAN = GRADIENT_TILE + 3


def gradient_transpose_reach(a: int, b: int, n: int) -> tuple:
    """The first and the last sample that K13's transposed stencils of
    indices a .. b - 1 along an axis of n >= 3 read (the kernel's
    treach_lo(a) and treach_hi(b, n)): j - 1 and j + 1 of each, and the
    faces' samples 0 (j <= 2) and n - 1 (j >= n - 3)."""
    return (0 if a <= 2 else a - 1), (n - 1 if b >= n - 2 else b)


# the one-sided stencils' weights on the samples 0, 1, 2 (the first row)
# and n - 3, n - 2, n - 1 (the last row), before the division by h
_FACE_LO = (-1.5, 2.0, -0.5)
_FACE_HI = (0.5, -2.0, 1.5)


def grad_axis_transpose(g: torch.Tensor, axis: int, h: float):
    """The transpose of :func:`grad_axis` along one axis, in ``g``'s dtype,
    in K13's order of terms: sample j of n takes (g[j-1] - g[j+1]) times
    1 / 2h, each term only where its row is central (1 <= j -+ 1 <= n - 2,
    else 0), then (w_j g[0]) times 1 / h for j <= 2 and (w'_j g[n-1])
    times 1 / h for j >= n - 3, with the one-sided rows' weights w and w'
    and the two reciprocals each formed once in Python's double."""
    n = g.shape[axis]
    inner = g.narrow(axis, 1, n - 2)
    pad = torch.zeros_like(g.narrow(axis, 0, 2))
    t = (torch.cat([pad, inner], dim=axis)
         - torch.cat([inner, pad], dim=axis)) * (1.0 / (2.0 * h))
    shape = [1] * g.dim()
    shape[axis] = 3
    for first, end, weights in ((0, 0, _FACE_LO), (n - 3, n - 1, _FACE_HI)):
        w = torch.tensor(weights, dtype=g.dtype, device=g.device).view(shape)
        t.narrow(axis, first, 3).add_(w * g.narrow(axis, end, 1)
                                      * (1.0 / h))
    return t


def _transpose_f64(d_field, spacing) -> torch.Tensor:
    """S^T d_field in float64, (W, H, D): the transpose of the packed map
    n-1 -> (S_x, S_y, S_z, 1) n-1, summed as K13 sums a voxel:
    ((x + z) + the value's cotangent) + y."""
    g = torch.as_tensor(d_field)
    if g.dim() != 4 or g.shape[3] != 4 or min(g.shape[:3]) < 3:
        raise ValueError(f"d_field: expected (D, H, W, 4) with D, H, W >= 3, "
                         f"got {tuple(g.shape)}")
    g = g.to(torch.float64).permute(2, 1, 0, 3)
    dx, dy, dz = (float(s) for s in np.asarray(spacing).ravel())
    return ((grad_axis_transpose(g[..., 0], 0, dx)
             + grad_axis_transpose(g[..., 2], 2, dz) + g[..., 3])
            + grad_axis_transpose(g[..., 1], 1, dy))


def gradient_field_transpose_plain(d_field, spacing,
                                   gladstone_dale: float) -> torch.Tensor:
    """The plain version of K13: (D, H, W, 4) cotangent of the packed field
    -> (W, H, D) float32 cotangent of rho, ``gladstone_dale`` S^T d_field
    (:func:`_transpose_f64`) formed in float64 and rounded once; on the
    device of ``d_field``."""
    return (gladstone_dale * _transpose_f64(d_field, spacing)).to(
        torch.float32).contiguous()


def launch_gradient_field_transpose(d_field: torch.Tensor, spacing,
                                    gladstone_dale: float) -> torch.Tensor:
    """Launch K13: the (D, H, W, 4) float32 cotangent of the packed field on
    a CUDA device -> the (W, H, D) float32 cotangent of rho, on K10's grid
    (:func:`gradient_plan`)."""
    kernels.check_kernel_input("d_field", d_field, None, torch.float32)
    if d_field.dim() != 4 or d_field.shape[3] != 4 or \
            min(d_field.shape[:3]) < 3:
        raise ValueError(f"d_field: expected (D, H, W, 4) with D, H, W >= 3, "
                         f"got {tuple(d_field.shape)}")
    dx, dy, dz = (float(s) for s in np.asarray(spacing).ravel())
    d, h, w = (int(n) for n in d_field.shape[:3])
    out = torch.empty((w, h, d), dtype=torch.float32, device=d_field.device)
    plan = gradient_plan(w, h, d)
    lib = kernels.load("volume_prep")
    with torch.cuda.device(d_field.device):
        code = lib.photon_gradient_field_transpose(
            d_field.data_ptr(), out.data_ptr(), w, h, d, dx, dy, dz,
            float(gladstone_dale), plan.y_run,
            kernels.current_stream(d_field.device))
    kernels.check_launch(code, "photon_gradient_field_transpose")
    launch_gradient_field_transpose.launches += 1
    return out


launch_gradient_field_transpose.launches = 0


def gradient_field_transpose(d_field: torch.Tensor, spacing,
                             gladstone_dale: float) -> torch.Tensor:
    """``gladstone_dale`` times the transpose of :func:`gradient_field` on
    a (D, H, W, 4) float32 cotangent -> (W, H, D) float32, on the same
    device: :func:`gradient_field_transpose_plain` on the CPU, K13 on a
    CUDA device."""
    if d_field.device.type == "cpu":
        return gradient_field_transpose_plain(d_field, spacing,
                                              gladstone_dale)
    return launch_gradient_field_transpose(d_field.contiguous(), spacing,
                                           gladstone_dale)


# ---------------------------------------------------------------------------
# K11 / K12: the cubic B-spline prefilter and its transpose
# ---------------------------------------------------------------------------

PREFILTER_POLE = float(np.sqrt(3.0) - 2.0)


def prefilter_constants(n: int):
    """(lam, z, last, zk) of the prefilter along an axis of n samples, each
    rounded to float32 as the plain version rounds it: the gain
    (1 - z)(1 - 1/z) formed in float64, z / (z^2 - 1) in float32, and z^k
    formed in float64 for the causal start's terms, ``zk`` (a float32
    array): down to |z|^k < 1e-7, at least 12 (13 for this pole), at most
    n."""
    f = np.float32
    z = f(PREFILTER_POLE)
    lam = float(f((1.0 - PREFILTER_POLE) * (1.0 - 1.0 / PREFILTER_POLE)))
    last = float(z / (z * z - f(1.0)))
    horizon = min(n, max(12, int(math.ceil(math.log(1e-7)
                                           / math.log(abs(PREFILTER_POLE))))))
    zk = (PREFILTER_POLE ** np.arange(horizon)).astype(f)
    return lam, float(z), last, zk


def _prefilter_axis(x, axis: int):
    """Causal then anticausal recursive filter along one axis, in f32, with
    the constants of :func:`prefilter_constants`."""
    # one unbind, not n selects: under autograd its backward is one stack,
    # where every select would allocate a cotangent the size of the field
    xs = x.movedim(axis, 0).unbind(0)
    n = len(xs)
    lam, z, last, zk = prefilter_constants(n)
    # the causal start summed in order k = 0, 1, ... on every device (a sum
    # over a stacked axis adds in an order of PyTorch's choosing, which
    # differs between the CPU and the card and with the shape)
    start = float(zk[0]) * xs[0]
    for k in range(1, len(zk)):
        start = start + float(zk[k]) * xs[k]
    causal = [lam * start]
    for i in range(1, n):
        causal.append(lam * xs[i] + z * causal[-1])
    out = [None] * n
    out[n - 1] = last * (z * causal[n - 2] + causal[n - 1])
    for i in range(n - 2, -1, -1):
        out[i] = z * (out[i + 1] - causal[i])
    return torch.stack(out).movedim(0, axis)


def bspline_prefilter_plain(field):
    """The plain version of K11: (D, H, W, C) samples -> cubic B-spline
    coefficients, along axes 0, 1 and 2 (``torch.autograd`` through it is
    K12's), on the field's device.  Pole sqrt(3) - 2, the causal start
    summed over a horizon of at most 13 .. n terms."""
    out = field
    for axis in (0, 1, 2):
        out = _prefilter_axis(out, axis)
    return out.contiguous()


class _Pole(ctypes.Structure):
    """csrc/volume_prep.cu's ``Pole``: one axis's constants."""
    _fields_ = [("zk", ctypes.c_float * 16), ("lam", ctypes.c_float),
                ("z", ctypes.c_float), ("last", ctypes.c_float),
                ("horizon", ctypes.c_int)]


class _AxisPlan(ctypes.Structure):
    """csrc/volume_prep.cu's ``AxisPlan``: one axis's route and tile."""
    _fields_ = [("tiled", ctypes.c_int), ("cols", ctypes.c_int),
                ("rows", ctypes.c_int), ("pitch", ctypes.c_int)]


@functools.lru_cache(maxsize=16)
def _poles(d: int, h: int, w: int):
    """The three axes' constants for a (d, h, w, C) field, made once a
    shape (the kernels only read them)."""
    poles = (_Pole * 3)()
    for axis, n in enumerate((d, h, w)):
        lam, z, last, zk = prefilter_constants(n)
        p = poles[axis]
        p.lam, p.z, p.last, p.horizon = lam, z, last, len(zk)
        for k, v in enumerate(zk):
            p.zk[k] = float(v)
    return poles


# The tiles of K11 and K12 (csrc/volume_prep.cu): a block of TILE_THREADS
# holds a tile of whole lines in shared memory and its first lines' worth
# of threads runs them, about TILE_LINES a tile, one warp.  A tile takes at
# most TILE_BYTES, so that three fit an SM's 228 KB (each block also
# reserves 1 KB), and at least TILE_MIN_LINES lines (all of the axis's
# where it has fewer); a line for which such a tile would pass the
# TILE_MAX_BYTES a block can take on an H100 goes to the one-thread-a-line
# kernel.
TILE_THREADS = 256
TILE_LINES = 32
TILE_MIN_LINES = 8
TILE_BYTES = 76_800
TILE_MAX_BYTES = 232_448


class AxisPlan(NamedTuple):
    """How K11 / K12 run one axis of a (D, H, W, C) field: its lines (o, j)
    for o < ``outer`` (the earlier indices) and j < ``stride`` (the later
    ones, C included) of ``n`` samples each, sample i at (o n + i) stride + j.
    ``tiled``: a tile a block, ``rows`` consecutive o by ``cols``
    consecutive j (all ``stride`` of them where ``cols == stride``),
    ``pitch`` floats of shared memory a row, ``tiles`` blocks,
    ``smem_bytes`` a block; else one thread a line."""
    n: int
    stride: int
    outer: int
    tiled: bool
    cols: int
    rows: int
    pitch: int
    tiles: int
    smem_bytes: int


def _axis_plan(n: int, stride: int, outer: int) -> AxisPlan:
    if stride <= TILE_LINES:
        # whole rows of n * stride contiguous floats; a row's pitch is
        # stride more than a multiple of 32 floats, so that line
        # k = r * stride + t reads sample i from bank (k + i * stride) % 32
        cols = stride
        least = min(outer, -(-TILE_MIN_LINES // stride))
        rows = min(outer, TILE_LINES // stride)

        def pitch_of(r):
            return n * cols if r == 1 else n * cols + (cols - n * cols) % 32
        while rows > least and rows * pitch_of(rows) * 4 > TILE_BYTES:
            rows -= 1
        pitch = pitch_of(rows)
        tiles = -(-outer // rows)
    else:
        # n rows of cols contiguous floats, [i][t] in shared memory
        rows = 1
        cols = next((c for c in (32, 16) if n * c * 4 <= TILE_BYTES),
                    TILE_MIN_LINES)
        pitch = n * cols
        tiles = outer * -(-stride // cols)
    smem = rows * pitch * 4
    if smem > TILE_MAX_BYTES:
        return AxisPlan(n, stride, outer, False, 0, 0, 0,
                        -(-outer * stride // 128), 0)
    return AxisPlan(n, stride, outer, True, cols, rows, pitch, tiles, smem)


@functools.lru_cache(maxsize=16)
def prefilter_plan(d: int, h: int, w: int, c: int):
    """The route and tile of each axis of a (d, h, w, c) field, from its
    shape alone (:class:`AxisPlan`; for the one-thread-a-line route
    ``tiles`` counts its blocks of 128 threads)."""
    dims = (d, h, w)
    return tuple(_axis_plan(dims[a], math.prod(dims[a + 1:]) * c,
                            math.prod(dims[:a])) for a in range(3))


def _plan_records(plans):
    """The C records of three :class:`AxisPlan` (kept alive by the
    caller)."""
    records = (_AxisPlan * 3)()
    for rec, p in zip(records, plans):
        rec.tiled, rec.cols, rec.rows, rec.pitch = (int(p.tiled), p.cols,
                                                    p.rows, p.pitch)
    return records


@functools.lru_cache(maxsize=16)
def _plan_records_of(d: int, h: int, w: int, c: int):
    return _plan_records(prefilter_plan(d, h, w, c))


def _check_field(name: str, t) -> None:
    kernels.check_kernel_input(name, t, None, torch.float32)
    if t.dim() != 4 or min(t.shape[:3]) < 2:
        raise ValueError(f"{name}: expected (D, H, W, C) with D, H, W >= 2, "
                         f"got {tuple(t.shape)}")


# kernel launches a prefilter call makes: one an axis (none where the field
# has no channels)
PREFILTER_AXES = 3


def _launch_prefilter(fn: str, t: torch.Tensor, plans=None) -> torch.Tensor:
    """Run ``fn`` (``photon_bspline_prefilter`` or ``_bwd``) on ``t`` along
    the shape's :func:`prefilter_plan`, or along ``plans`` (three
    :class:`AxisPlan`; chip_smoke times the one-thread-a-line route with
    it)."""
    shape = tuple(int(n) for n in t.shape)
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    poles = _poles(*shape[:3])
    records = (_plan_records_of(*shape) if plans is None
               else _plan_records(plans))
    lib = kernels.load("volume_prep")
    with torch.cuda.device(t.device):
        code = getattr(lib, fn)(t.data_ptr(), out.data_ptr(), *shape,
                                ctypes.addressof(poles),
                                ctypes.addressof(records),
                                kernels.current_stream(t.device))
    kernels.check_launch(code, fn)
    return out


def launch_prefilter(field: torch.Tensor) -> torch.Tensor:
    """Launch K11 (three launches, axes 0, 1, 2): B-spline coefficients of a
    (D, H, W, C) float32 field on a CUDA device."""
    _check_field("field", field)
    out = _launch_prefilter("photon_bspline_prefilter", field)
    launch_prefilter.launches += PREFILTER_AXES if field.shape[3] else 0
    return out


def launch_prefilter_bwd(ct: torch.Tensor) -> torch.Tensor:
    """Launch K12 (three launches, axes 2, 1, 0): the field's cotangent from
    the coefficients' cotangent ``ct``."""
    _check_field("ct", ct)
    out = _launch_prefilter("photon_bspline_prefilter_bwd", ct)
    launch_prefilter_bwd.launches += PREFILTER_AXES if ct.shape[3] else 0
    return out


launch_prefilter.launches = 0
launch_prefilter_bwd.launches = 0


class _BSplinePrefilter(torch.autograd.Function):
    """The prefilter on the card, K11 forward and K12 backward."""

    @staticmethod
    def forward(ctx, field):
        return launch_prefilter(field)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        with span("prefilter.transpose"):
            return launch_prefilter_bwd(ct.contiguous())


def bspline_prefilter(field: torch.Tensor) -> torch.Tensor:
    """(D, H, W, C) samples -> cubic B-spline coefficients along axes 0, 1
    and 2, differentiable, on the field's device: the plain version on the
    CPU, K11 (backward K12) on a CUDA device."""
    if field.device.type == "cpu":
        return bspline_prefilter_plain(field)
    with span("prefilter.coefficients"):
        return _BSplinePrefilter.apply(field.contiguous())


# ---------------------------------------------------------------------------
# The NRRD header probe
# ---------------------------------------------------------------------------

_INT = re.compile(r"\s*([+-]?\d+)")
_REAL = re.compile(r"\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


def _scan(value: str, pattern, convert):
    """Three reads of C++'s ``istringstream >> x``: each takes the next
    number; from the first that fails on, every slot reads 0."""
    out, pos = [], 0
    for _ in range(3):
        m = pattern.match(value, pos)
        if m is None:
            break
        out.append(convert(m.group(1)))
        pos = m.end()
    return out + [convert("0")] * (3 - len(out))


def nrrd_probe(path: str):
    """NRRD header probe -> ``(sizes, spacings, origin, payload_offset)``,
    or None for a file the probe does not take: missing, not NRRD, or other
    than raw float32 (then ``utils.nrrd_io.read_nrrd`` reads it).  Sizes are
    ints, spacings (default 1) and origin (default 0) floats, the offset the
    payload's first byte."""
    try:
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        first = f.readline()
        if not first.startswith(b"NRRD"):
            return None
        raw = floats = False
        sizes, spacings, origin = [0, 0, 0], [1.0] * 3, [0.0] * 3
        offset = -1
        for line in iter(f.readline, b""):
            text = line.decode("latin-1").rstrip("\n").removesuffix("\r")
            if not text:
                offset = f.tell()
                break
            if text.startswith("#") or ":" not in text:
                continue
            key, _, value = text.partition(":")
            value = value.lstrip("= ")
            if key == "type":
                floats = value in ("float", "f4", "float32")
            elif key == "encoding":
                raw = value == "raw"
            elif key == "sizes":
                sizes = _scan(value, _INT, int)
            elif key == "spacings":
                spacings = _scan(value, _REAL, float)
            elif key == "space origin":
                origin = _scan(re.sub(r"[(),]", " ", value), _REAL, float)
    if not (raw and floats and sizes[0] > 0):
        return None
    return tuple(sizes), tuple(spacings), tuple(origin), offset
