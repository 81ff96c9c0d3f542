"""Volume sampling of the exact path: tex3D trilinear and tricubic B-spline.

Counterpart of ``photon_tpu/ops/interp.py`` (the reference's texture-unit
interpolation, trace_rays_through_density_gradients.h:77-81, 195-277, and
the vendored CubicInterpolationCUDA):

* the texture coordinate ``lookup = 1 + frac * (N - 2)`` (ref:
  calculate_lookup_index :195-215) and the in-volume predicates
  (ray_inside_box :217-251, access_refractive_index :253-277);
* trilinear fetches with CUDA's convention that a coordinate ``x`` samples
  voxel centres at ``x - 0.5`` with clamped addressing: the 8 corners of
  every ray in one gather from the flat field, blended with the weights
  ``wz * wy * wx`` in the JAX package's (z, y, x) corner order;
* tricubic B-spline interpolation of prefiltered coefficients over the
  4 x 4 x 4 neighbourhood with clamped addressing.  The coefficients come
  from the port's one prefilter, ``ops/march_dense.bspline_prefilter``
  (float32, on the field's device: the kernel K11 of ``native.py`` on a
  CUDA device, its plain version on the CPU), where the JAX package's exact
  path prefilters in float64 numpy.

A march calls these once or more a step on every ray, so its points are
component-major, (3, N) (each row contiguous on the card), and
:class:`Grid` holds the volume's constants as tensors on the rays' device,
made once: a tensor made from Python numbers on a call would be a copy to
the card, and a wait, every time.  The samplers gather from the field laid
out channel by channel, (C, D*H*W), corner-major, and add the corners in
order along a leading axis: PyTorch's gather of rows of four floats, and
its sum over a trailing axis of 8, were each several times slower on an
H100, and its sum over the corner axis rounds by the batch's width.  Indices
are int32 where the field allows.  The public functions take the JAX
package's arguments and layouts, (N, 3) points and (D*H*W, C) fields, and
make a grid per call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Grid(NamedTuple):
    """A volume's sampling constants on one device, shaped (3, 1) to meet
    component-major (3, N) points; the integer tensors are int32 for a field
    of fewer than 2^31 voxels, else int64."""
    sizes: tuple               # (W, H, D)
    lo: torch.Tensor           # f32 min bound
    hi: torch.Tensor           # f32 max bound
    span: torch.Tensor         # f32 max - min
    n: torch.Tensor            # f32 (W, H, D)
    nm2: torch.Tensor          # f32 (W, H, D) - 2
    zero: torch.Tensor         # int zeros
    nmax: torch.Tensor         # int (W, H, D) - 1
    strides: torch.Tensor      # int flat-index strides (1, W, W H)


def make_grid(sizes, min_bound, max_bound) -> Grid:
    """``min_bound`` / ``max_bound``: (3,) float32 tensors on the device."""
    w, h, d = (int(s) for s in sizes)
    dev = min_bound.device
    itype = torch.int32 if w * h * d < 2 ** 31 else torch.int64

    def col(values, dtype):
        return torch.tensor(values, dtype=dtype).reshape(3, 1).to(dev)
    lo = min_bound.reshape(3, 1)
    hi = max_bound.reshape(3, 1)
    n = col((w, h, d), torch.float32)
    return Grid(sizes=(w, h, d), lo=lo, hi=hi, span=hi - lo, n=n,
                nm2=n - 2.0, zero=col((0, 0, 0), itype),
                nmax=col((w - 1, h - 1, d - 1), itype),
                strides=col((1, w, w * h), itype))


def lookup_in(grid: Grid, pos):
    """World positions (3, N) -> texture coordinates (3, N),
    ``1 + (pos - min) / (max - min) * (N - 2)``."""
    return 1.0 + (pos - grid.lo) / grid.span * grid.nm2


def accessible_in(grid: Grid, lookup):
    """The lookup-range predicate (ref: access_refractive_index:253-277)."""
    return ((lookup >= 0) & (lookup < grid.n)).all(dim=0)


def inside_in(grid: Grid, pos, accessible):
    """The reference's ray-in-volume predicate (ref: ray_inside_box
    :217-251), given :func:`accessible_in` of the position's lookup."""
    return ((pos >= grid.lo) & (pos < grid.hi)).all(dim=0) & accessible


def _corners(grid: Grid, base, taps: int):
    """Flat indices (taps^3, N) of the clamped neighbourhood that starts at
    ``base`` (3, N), in the JAX package's (z, y, x) order."""
    c = torch.stack([torch.clamp(base + o, grid.zero, grid.nmax)
                     for o in range(taps)]) * grid.strides  # (taps, 3, N)
    idx = (c[:, 2, None, None] + c[None, :, 1, None]
           + c[None, None, :, 0])                  # (taps, taps, taps, N)
    return idx.reshape(taps ** 3, -1)


def _weights(w):
    """Products wz * wy * wx (taps^3, N) of per-axis weights (taps, 3, N),
    in the JAX package's order."""
    taps = w.shape[0]
    wgt = (w[:, 2, None, None] * w[None, :, 1, None]
           * w[None, None, :, 0])
    return wgt.reshape(taps ** 3, -1)


def _blend(field_t, idx, wgt):
    """sum_k wgt[k] * field[idx[k]] -> (C, N), from the channel-major
    field ``field_t`` (C, D*H*W), the corners added in order: PyTorch's sum
    over the corner axis adds the last columns of a CPU batch in another
    order, by the batch's width, and a ray's sample must not depend on the
    batch that carries it (the ray dumps trace a chunk at a time)."""
    terms = wgt * field_t[:, idx]
    acc = terms[:, 0]
    for k in range(1, terms.shape[1]):
        acc = acc + terms[:, k]
    return acc


def trilinear_in(grid: Grid, field_t, lookup):
    """Trilinear fetch replicating ``tex3D`` with clamped addressing: (C, N)
    samples at (3, N) lookups of the channel-major field (C, D*H*W)."""
    u = lookup - 0.5                                   # voxel-centre space
    i0f = torch.floor(u)
    t = u - i0f
    idx = _corners(grid, i0f.to(grid.zero.dtype), 2)
    return _blend(field_t, idx, _weights(torch.stack([1 - t, t])))


def _bspline_weights(t):
    """The four cubic B-spline basis weights for fraction t in [0, 1),
    each divided by 6 held in a 0-dim tensor on t's device: on the card
    PyTorch multiplies a tensor by the rounded reciprocal of a Python (or
    CPU-scalar) divisor, where the CPU divides, and a third of the weights
    would part by an ulp (some 8% of the bench pair's cubic rays then left
    the volume a few ulp apart)."""
    six = t.new_full((), 6.0)
    one = 1.0 - t
    w0 = (one * one * one) / six
    w1 = (3.0 * t * t * t - 6.0 * t * t + 4.0) / six
    w2 = (-3.0 * t * t * t + 3.0 * t * t + 3.0 * t + 1.0) / six
    w3 = (t * t * t) / six
    return w0, w1, w2, w3


def tricubic_in(grid: Grid, coeff_t, lookup):
    """Tricubic B-spline interpolation of prefiltered coefficients (channel
    major, (C, D*H*W)) at (3, N) lookups, with the coordinate convention of
    :func:`trilinear_in`; returns (C, N)."""
    u = lookup - 0.5
    i0 = torch.floor(u)
    t = u - i0
    idx = _corners(grid, i0.to(grid.zero.dtype) - 1, 4)
    return _blend(coeff_t, idx, _weights(torch.stack(_bspline_weights(t))))


# ---------------------------------------------------------------------------
# The JAX package's functions, each making its grid
# ---------------------------------------------------------------------------

def _grid_of(sizes, like, min_bound=None, max_bound=None):
    if min_bound is None:
        min_bound = max_bound = torch.zeros(3, dtype=torch.float32,
                                            device=like.device)
    return make_grid(sizes, min_bound, max_bound)


def texture_lookup(pos, min_bound, max_bound, sizes):
    """World position (N, 3) -> texture coordinate per axis (``min_bound``
    / ``max_bound``: (3,) tensors on ``pos``' device; ``sizes`` (W, H, D))."""
    return lookup_in(_grid_of(sizes, pos, min_bound, max_bound), pos.t()).t()


def can_access(lookup, sizes):
    """Lookup-range-only predicate (ref: access_refractive_index:253-277)."""
    return accessible_in(_grid_of(sizes, lookup), lookup.t())


def inside_box(pos, lookup, min_bound, max_bound, sizes):
    """The reference's ray-in-volume predicate (ref: ray_inside_box:217-251)."""
    grid = _grid_of(sizes, pos, min_bound, max_bound)
    return inside_in(grid, pos.t(), accessible_in(grid, lookup.t()))


def sample_trilinear(field_flat, sizes, lookup):
    """Trilinear fetch: ``field_flat`` (D*H*W, C), index z*H*W + y*W + x;
    ``sizes`` (W, H, D); ``lookup`` (N, 3).  Returns (N, C)."""
    return trilinear_in(_grid_of(sizes, lookup), field_flat.t(),
                        lookup.t()).t()


def sample_tricubic(coeff_flat, sizes, lookup):
    """Tricubic B-spline interpolation of prefiltered coefficients
    (D*H*W, C) at ``lookup`` (N, 3); returns (N, C)."""
    return tricubic_in(_grid_of(sizes, lookup), coeff_flat.t(),
                       lookup.t()).t()
