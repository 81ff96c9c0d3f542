"""Applying the march to a particle's ray fan.

Counterpart of ``photon_tpu/ops/march_fast.py``, of which the port keeps
only :func:`apply_chief_deltas`: the voxel-tube march there exists because a
TPU cannot gather, and the gather march of ``ops/march_dense_fused.py``
covers its role on a GPU.  It also takes one march a ray, the port's
``chief_march=False``.
"""
from __future__ import annotations

import torch


def apply_chief_deltas(deltas, px, py, pz, dx, dy, dz):
    """Advance (P, R) rays through the volume by march deltas.

    ``deltas``: ``(z_exit, dpos_x, dpos_y, ddir_x, ddir_y, ddir_z)``, six (P,)
    tensors (a particle's chief ray, broadcast over its fan) or six (P, R)
    tensors (each ray's own march)."""
    per_ray = deltas[0].dim() == 2
    z_exit, dpos_x, dpos_y, ddx, ddy, ddz = (
        d if per_ray else d[:, None] for d in deltas)
    t = (z_exit - pz) / dz
    px = px + dx * t + dpos_x
    py = py + dy * t + dpos_y
    pz = z_exit.expand_as(pz)
    ox = dx + ddx
    oy = dy + ddy
    oz = dz + ddz
    inv = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return px, py, pz, ox * inv, oy * inv, oz * inv
