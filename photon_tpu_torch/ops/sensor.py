"""Sensor integration of the exact path: ray -> pixel scatter-add.

Counterpart of ``photon_tpu/ops/sensor.py`` (the reference's sensor stage):

* the erf diffraction spot of every ray (parallel_ray_tracing.cu
  intersect_sensor_02 :1383-1543, and the same splat inside
  create_apparent_image :1660-1730), with the circular render mask;
* the 4-pixel bilinear deposit (intersect_sensor :1735-1895, accumulated at
  :2216-2234 with the reference's ``(ii-1)*nx + (jj-1)`` shift);
* cos^4 vignetting (:1467-1472).

A ray deposits a static K x K window of masked weights; every weight goes
to the image in one ``index_add_``.  The JAX package's scatter drops
out-of-range indices (``mode="drop"``); on the card an out-of-range index
is a device-side assert.  So a weight the JAX package masks is zeroed
exactly as there, and its index is then replaced by one inside the image,
the ray's own number modulo the image's size: adding +0.0 changes no pixel,
and the masked deposits of culled rays, which all sit at pixel (0, 0), do
not pile onto a few addresses.  The scatter sums in float64 and rounds
once: on the card ``index_add_`` adds with atomics in an order that changes
between runs, and a float32 sum of the ~2000 deposits a pixel takes at the
bench's 6e7 rays moved the image maximum by 1.4e-5 between two runs on an
H100 (chip_smoke.py, phase 11).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_SQRT8 = float(np.float32(math.sqrt(8.0)))


def sensor_coordinates(pos_xy, pixel_pitch: float, nx: int, ny: int,
                       mirror_x: bool):
    """Sensor-plane (x, y) in microns -> fractional pixel coordinates
    (d_x, d_y) (ref: parallel_ray_tracing.cu:1441-1447)."""
    x, y = pos_xy[..., 0], pos_xy[..., 1]
    pixel_1_x = -pixel_pitch * (nx - 1) / 2.0
    pixel_1_y = -pixel_pitch * (ny - 1) / 2.0
    d_x = (x - pixel_1_x) / pixel_pitch
    if mirror_x:
        d_x = (nx - 1) - d_x
    d_y = (y - pixel_1_y) / pixel_pitch
    return d_x, d_y


def cos4_falloff(direction):
    """cos^4 of the ray's angle to the sensor normal (ref: :1467-1472)."""
    dz = direction[..., 2]
    tx = direction[..., 0] / dz
    ty = direction[..., 1] / dz
    # cos^2(atan(sqrt(t))) = 1 / (1 + t)
    cos2 = 1.0 / (1.0 + (tx * tx + ty * ty))
    return cos2 * cos2


def _splat_window(diameter: float, render_fraction: float) -> int:
    """Window width covering [floor(X - rf*D), ceil(X + rf*D)]."""
    return int(math.floor(2 * render_fraction * diameter)) + 2


def _scatter(flat_idx, w, keep, nx: int, ny: int):
    """The (ny, nx) image of weights ``w`` (N, ...) added at ``flat_idx``
    where ``keep`` is true; the other entries add +0.0 at the ray's spare
    index."""
    n = w.shape[0]
    ray = torch.arange(n, device=w.device).remainder(nx * ny)
    flat = torch.where(keep, flat_idx,
                       ray.reshape((n,) + (1,) * (flat_idx.dim() - 1)))
    w = torch.where(keep, w, 0.0)
    image = torch.zeros(ny * nx, dtype=torch.float64, device=w.device)
    image.index_add_(0, flat.reshape(-1), w.reshape(-1).to(torch.float64))
    return image.to(torch.float32).reshape(ny, nx)


def _ok_rays(d_x, d_y, valid, nx: int, ny: int):
    on_sensor = (d_x >= 0) & (d_x < nx) & (d_y >= 0) & (d_y < ny)
    return valid & on_sensor & torch.isfinite(d_x) & torch.isfinite(d_y)


def diffraction_splat(pos, direction, radiance, valid, *, nx: int, ny: int,
                      pixel_pitch: float, diameter: float,
                      render_fraction: float = 0.75, mirror_x: bool = True):
    """Gaussian-erf diffraction-spot integration of every ray.

    Each ray deposits an erf-windowed spot of ``diameter`` pixels, scaled by
    radiance * cos^4(alpha) * 8/pi * pi/32 (ref: :1477-1540).  ``pos``:
    (N, 3) sensor-plane positions (microns); ``direction``: (N, 3);
    ``radiance``: (N,); ``valid``: (N,) bool.  Returns the (ny, nx) float32
    image."""
    d_x, d_y = sensor_coordinates(pos, pixel_pitch, nx, ny, mirror_x)
    ok = _ok_rays(d_x, d_y, valid, nx, ny)

    amp = radiance.to(torch.float32) * cos4_falloff(direction) \
        * (8.0 / math.pi)
    amp = torch.where(ok, amp, 0.0)
    # culled rays -> harmless coordinates, so the index math stays finite
    X = torch.where(ok, d_x - 0.5, 0.0)
    Y = torch.where(ok, d_y - 0.5, 0.0)

    K = _splat_window(diameter, render_fraction)
    rf_d = float(np.float32(render_fraction * diameter))
    col0 = torch.floor(X - rf_d).to(torch.int64)
    row0 = torch.floor(Y - rf_d).to(torch.int64)
    offs = torch.arange(K, dtype=torch.int64, device=pos.device)
    cols = col0[:, None] + offs[None, :]              # (N, K)
    rows = row0[:, None] + offs[None, :]

    # separable erf-difference weights along each axis
    fc = cols.to(X.dtype) - X[:, None]
    fr = rows.to(Y.dtype) - Y[:, None]
    wx = torch.erf(_SQRT8 * (fc - 0.5) / diameter) \
        - torch.erf(_SQRT8 * (fc + 0.5) / diameter)
    wy = torch.erf(_SQRT8 * (fr - 0.5) / diameter) \
        - torch.erf(_SQRT8 * (fr + 0.5) / diameter)

    # circular render mask + sensor bounds (ref: :1514-1519)
    r2 = fc[:, None, :] * fc[:, None, :] + fr[:, :, None] * fr[:, :, None]
    in_circle = r2 <= float(np.float32(rf_d) * np.float32(rf_d))
    in_bounds = ((cols[:, None, :] >= 0) & (cols[:, None, :] <= nx - 1)
                 & (rows[:, :, None] >= 0) & (rows[:, :, None] <= ny - 1))
    w = amp[:, None, None] * (math.pi / 32.0) * wy[:, :, None] \
        * wx[:, None, :]
    return _scatter(rows[:, :, None] * nx + cols[:, None, :], w,
                    in_circle & in_bounds, nx, ny)


def bilinear_splat(pos, direction, radiance, valid, *, nx: int, ny: int,
                   pixel_pitch: float, legacy_index_shift: bool = True):
    """4-pixel area-weighted integration (no diffraction; ref:
    intersect_sensor :1735-1895 and the accumulation at :2216-2234).
    ``legacy_index_shift`` reproduces the reference's ``(ii-1)*nx + (jj-1)``
    accumulation; False is the geometrically centred variant."""
    d_x, d_y = sensor_coordinates(pos, pixel_pitch, nx, ny, mirror_x=False)
    ok = _ok_rays(d_x, d_y, valid, nx, ny)

    amp = radiance.to(torch.float32) * cos4_falloff(direction)
    amp = torch.where(ok, amp, 0.0)
    d_x = torch.where(ok, d_x, 0.0)
    d_y = torch.where(ok, d_y, 0.0)

    d_x_lower = d_x - 0.5
    d_y_lower = d_y - 0.5
    d_ii = torch.ceil(d_y_lower) - d_y_lower   # overlap fraction, upper row
    d_jj = torch.ceil(d_x_lower) - d_x_lower   # overlap fraction, left column
    ii_u = (torch.ceil(d_y_lower) - 1).to(torch.int64)
    jj_l = (torch.ceil(d_x_lower) - 1).to(torch.int64)

    # stacked (N, 4): upper left, upper right, lower left, lower right
    ii = torch.stack([ii_u, ii_u, ii_u + 1, ii_u + 1], dim=-1)
    jj = torch.stack([jj_l, jj_l + 1, jj_l, jj_l + 1], dim=-1)
    w = torch.stack([d_ii * d_jj, d_ii * (1 - d_jj),
                     (1 - d_ii) * d_jj, (1 - d_ii) * (1 - d_jj)], dim=-1)
    in_bounds = (ii >= 0) & (ii < ny) & (jj >= 0) & (jj < nx)
    w = torch.where(in_bounds, w * amp[:, None], 0.0)

    shift = 1 if legacy_index_shift else 0
    # the legacy shift makes indices negative at the first row and column:
    # the JAX package routes them to a sentinel its scatter drops
    keep = in_bounds & (ii - shift >= 0) & (jj - shift >= 0)
    return _scatter((ii - shift) * nx + (jj - shift), w, keep, nx, ny)
