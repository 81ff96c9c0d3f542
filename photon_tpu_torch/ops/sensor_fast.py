"""Per-particle erf splat: anchors, sentinels and the plain scatter.

Counterpart of ``photon_tpu/ops/sensor_fast.py``, of which this slice needs
:func:`particle_splat`: one erf spot per *particle* at its
amplitude-weighted ray centroid.  ``patch_splat`` (per-ray spots under
position noise) and ``bilinear_patch_splat`` arrive with the PIV / noise /
bilinear slice (ROADMAP.md).

:func:`_particle_splat_plain` is the plain version of the splat kernel of
``ops/splat.py``: (P, K, K) patches with the circular render mask, scattered
with ``index_add_``; ``torch.autograd`` through it is the plain version of
the splat's transpose kernel.  The ``where(safe, ...)``, the pi/32 scale and
the centroid division stay plain PyTorch around the kernels on either device.
"""
from __future__ import annotations

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
