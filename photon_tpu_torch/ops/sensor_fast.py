"""Sensor deposits: the per-particle erf splat and the per-ray deposits.

Counterpart of ``photon_tpu/ops/sensor_fast.py``.  :func:`particle_splat`
puts one erf spot per *particle* at its amplitude-weighted ray centroid
through the splat kernel of ``ops/splat.py``; :func:`patch_splat` (an erf
spot per ray, under position noise or ``per_ray_splat``) and
:func:`bilinear_patch_splat` (the bilinear sensor's 4-pixel deposit per ray)
deposit every ray of a (P, R) fan.

:func:`_particle_splat_plain` is the plain version of the splat kernel:
(P, K, K) patches with the circular render mask, scattered with
``index_add_``; ``torch.autograd`` through it is the plain version of the
splat's transpose kernel.  The ``where(safe, ...)``, the pi/32 scale and
the centroid division stay plain PyTorch around the kernels on either device.

The per-ray deposits are XLA in the JAX package, not Pallas: a product of
(K, P, R) weight stacks over the rays and a scatter.  They are the same
here, ``einsum`` and ``index_add_``, on every device, with the product in
full float32 whatever the global TF32 setting (:class:`_PatchProduct`).
"""
from __future__ import annotations

import contextlib
import math

import torch

_SQRT8 = math.sqrt(8.0)


def _erf_pair(f, diameter: float):
    """erf(sqrt8 (f - .5)/D) - erf(sqrt8 (f + .5)/D) (ref: :1529-1533)."""
    return torch.erf(_SQRT8 * (f - 0.5) / diameter) \
        - torch.erf(_SQRT8 * (f + 0.5) / diameter)


def _scatter_patches(patches, col0, row0, nx: int, ny: int):
    """Add (P, K, K) [row, col] patches at their anchors; out-of-frame
    pixels are dropped (they land in a spare bin past the image)."""
    K = patches.shape[-1]
    ar = torch.arange(K, dtype=torch.int64, device=patches.device)
    cols = col0.to(torch.int64)[:, None, None] + ar[None, None, :]
    rows = row0.to(torch.int64)[:, None, None] + ar[None, :, None]
    in_bounds = (cols >= 0) & (cols < nx) & (rows >= 0) & (rows < ny)
    flat = torch.where(in_bounds, rows * nx + cols,
                       torch.full_like(rows, nx * ny))
    image = torch.zeros(ny * nx + 1, dtype=torch.float32,
                        device=patches.device)
    image.index_add_(0, flat.reshape(-1), patches.reshape(-1))
    return image[:ny * nx].reshape(ny, nx)


def _particle_splat_plain(Xs, Ys, A, col0, row0, *, K: int, ny: int, nx: int,
                          diameter: float, render_fraction: float):
    """Plain patch + scatter formulation of the particle splat."""
    ar = torch.arange(K, dtype=torch.int32, device=Xs.device)
    fc = (col0[:, None] + ar[None]).to(Xs.dtype) - Xs[:, None]    # (P, K)
    fr = (row0[:, None] + ar[None]).to(Ys.dtype) - Ys[:, None]
    wx = _erf_pair(fc, diameter)                                  # (P, K)
    wy = _erf_pair(fr, diameter) * A[:, None]
    patches = wy[:, :, None] * wx[:, None, :]         # (P, K, K) [row, col]
    rf_d = torch.tensor(render_fraction * diameter, dtype=torch.float32,
                        device=Xs.device)
    in_circle = (fc[:, None, :] ** 2 + fr[:, :, None] ** 2) <= rf_d * rf_d
    patches = torch.where(in_circle, patches, torch.zeros_like(patches))
    return _scatter_patches(patches, col0, row0, nx, ny)


def particle_splat(Xbar, Ybar, A, pred_col, pred_row, *, nx: int, ny: int,
                   diameter: float, patch: int = 12,
                   render_fraction: float = 0.75):
    """One erf spot per *particle* at its amplitude-weighted ray centroid.

    Valid whenever a particle's rays land within a small fraction of a
    pixel of each other (always true for the reference's ray-cone and
    diffraction defaults).  The erf profile is evaluated per particle per
    patch pixel; the reference's circular render mask (pixels beyond
    render_fraction * diameter of the centre deposit nothing,
    parallel_ray_tracing.cu:1514-1519) applies per particle.

    The anchor window is clamped fully inside the frame: erf weights
    depend only on ``pixel - centre``, so the clamp never changes a
    visible pixel (the circular mask bounds the support).

    Args:
      Xbar, Ybar: (P,) amplitude-weighted splat centres (pixel coords).
      A: (P,) summed ray amplitude (radiance * cos^4 * 8/pi), zero for
        particles with no surviving rays.
      pred_col, pred_row: (P,) int32 rounded centres (patch anchors).
    """
    K = int(patch)
    # the clamp above is only sound when the circular render mask fits the
    # patch; a caller passing a small explicit patch with a large diameter
    # must fail loudly rather than silently changing edge deposits
    if render_fraction * diameter > (K - 1) / 2:
        raise ValueError(
            f"patch={K} cannot contain the circular render mask "
            f"(render_fraction * diameter = {render_fraction * diameter}"
            f" > (patch-1)/2); enlarge patch")
    col0 = (pred_col - K // 2).clamp(0, max(nx - K, 0)).to(torch.int32)
    row0 = (pred_row - K // 2).clamp(0, max(ny - K, 0)).to(torch.int32)
    safe = torch.isfinite(Xbar) & torch.isfinite(Ybar) & (A > 0)
    Xs = torch.where(safe, Xbar, torch.full_like(Xbar, -1e6))
    Ys = torch.where(safe, Ybar, torch.full_like(Ybar, -1e6))
    A = torch.where(safe, A, torch.zeros_like(A)) * (math.pi / 32.0)

    from photon_tpu_torch.ops.splat import splat_particles
    return splat_particles(Xs, Ys, A, col0, row0, K=K, ny=int(ny), nx=int(nx),
                           diameter=float(diameter),
                           render_fraction=float(render_fraction))


# ---------------------------------------------------------------------------
# per-ray deposits
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_f32():
    """Matrix products in full float32 for the block, whatever the global
    TF32 setting (restored on leaving)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _PatchProduct(torch.autograd.Function):
    """(K, P, R) row and column weight stacks -> (P, K, K) [row, col]
    patches, a sum over each particle's rays; forward and backward in full
    float32."""

    @staticmethod
    def forward(ctx, wy, wx):
        ctx.save_for_backward(wy, wx)
        with _full_f32():
            return torch.einsum("ipr,jpr->pij", wy, wx)

    @staticmethod
    def backward(ctx, ct):
        wy, wx = ctx.saved_tensors
        with _full_f32():
            return (torch.einsum("pij,jpr->ipr", ct, wx),
                    torch.einsum("pij,ipr->jpr", ct, wy))


def _per_ray_anchors(X, Y, amp, pred_col, pred_row, K: int, nx: int,
                     ny: int):
    """Patch anchors ``clip(pred - K//2, -K, n-1)`` and the rays masked by
    ``safe`` (finite centre, positive amplitude): (col0, row0, Xs, Ys, amp),
    the anchors (P,) int64."""
    col0 = (pred_col.to(torch.int64) - K // 2).clamp(-K, nx - 1)
    row0 = (pred_row.to(torch.int64) - K // 2).clamp(-K, ny - 1)
    safe = torch.isfinite(X) & torch.isfinite(Y) & (amp > 0)
    far = torch.full_like(X, -1e6)
    return (col0, row0, torch.where(safe, X, far), torch.where(safe, Y, far),
            torch.where(safe, amp, torch.zeros_like(amp)))


def _offsets(anchor, K: int):
    """(K, P, 1) int64 patch rows or columns of each particle."""
    return anchor[None, :, None] + torch.arange(
        K, dtype=torch.int64, device=anchor.device)[:, None, None]


def patch_splat(X, Y, amp, pred_col, pred_row, *, nx: int, ny: int,
                diameter: float, patch: int = 12):
    """Accumulate an erf spot per ray into the (ny, nx) image.

    ``X``, ``Y``: (P, R) spot centres in pixel coordinates (``d_x - 0.5`` /
    ``d_y - 0.5``, x already mirrored); ``amp``: (P, R) amplitudes
    (radiance * cos^4 * 8/pi, zero for culled rays); ``pred_col``,
    ``pred_row``: (P,) patch anchors.  Each particle accumulates a K x K
    patch over its rays: a ray farther than ~K/2 - D px from its anchor loses
    its tail.  No circular render mask, as in the JAX package (its tail
    there is under 1e-3 of the peak); the pi/32 scale folds into the rows.
    """
    K = int(patch)
    col0, row0, Xs, Ys, amp = _per_ray_anchors(X, Y, amp, pred_col,
                                               pred_row, K, nx, ny)
    wx = _erf_pair(_offsets(col0, K).to(Xs.dtype) - Xs[None], diameter)
    wy = _erf_pair(_offsets(row0, K).to(Ys.dtype) - Ys[None], diameter)
    wy = wy * (amp * (math.pi / 32.0))[None]
    return _scatter_patches(_PatchProduct.apply(wy, wx), col0, row0, nx, ny)


def bilinear_patch_splat(X, Y, amp, pred_col, pred_row, *, nx: int, ny: int,
                         patch: int = 12):
    """Per-ray 4-pixel bilinear deposit (the sensor without diffraction).

    The deposit is a 2-tap hat centred at ``d_x - 0.5`` / ``d_y - 0.5`` (x
    not mirrored), accumulated per particle as :func:`patch_splat`'s
    patches.  The reference's legacy ``(ii-1)*nx + (jj-1)`` accumulation
    shift (parallel_ray_tracing.cu:2228) scatters the patches one row and
    one column up-left; the weights are masked on the *unshifted* pixel
    bounds (intersect_sensor, :1735-1895).  ``amp``: radiance * cos^4 (no
    8/pi here)."""
    K = int(patch)
    col0, row0, Xs, Ys, amp = _per_ray_anchors(X, Y, amp, pred_col,
                                               pred_row, K, nx, ny)
    cols, rows = _offsets(col0, K), _offsets(row0, K)
    zero = torch.zeros((), dtype=Xs.dtype, device=Xs.device)

    def hat(f):
        return (1.0 - f.abs()).clamp_min(0.0)

    wx = torch.where((cols >= 0) & (cols <= nx - 1),
                     hat(cols.to(Xs.dtype) - Xs[None]), zero)
    wy = torch.where((rows >= 0) & (rows <= ny - 1),
                     hat(rows.to(Ys.dtype) - Ys[None]), zero) * amp[None]
    return _scatter_patches(_PatchProduct.apply(wy, wx), col0 - 1, row0 - 1,
                            nx, ny)
