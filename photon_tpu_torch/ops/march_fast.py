"""Applying the chief-ray march to a particle's ray fan.

Counterpart of ``photon_tpu/ops/march_fast.py``, of which the port keeps
only :func:`apply_chief_deltas`: the voxel-tube march there exists because a
TPU cannot gather, and the gather march of ``ops/march_dense_fused.py``
covers its role on a GPU.
"""
from __future__ import annotations

import torch


def apply_chief_deltas(deltas, px, py, pz, dx, dy, dz):
    """Advance a (P, R) ray fan through the volume using chief deltas."""
    z_exit, dpos_x, dpos_y, ddx, ddy, ddz = deltas
    t = (z_exit[:, None] - pz) / dz
    px = px + dx * t + dpos_x[:, None]
    py = py + dy * t + dpos_y[:, None]
    pz = z_exit[:, None].expand_as(pz)
    ox = dx + ddx[:, None]
    oy = dy + ddy[:, None]
    oz = dz + ddz[:, None]
    inv = 1.0 / torch.sqrt(ox * ox + oy * oy + oz * oz)
    return px, py, pz, ox * inv, oy * inv, oz * inv
