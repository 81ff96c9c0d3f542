"""The particle splat as one CUDA kernel, and its wrapper.

Kernel: ``csrc/splat.cu`` (``photon_splat``).  It replaces both TPU kernels
of ``photon_tpu/ops/splat_pallas.py``: ``_splat_kernel`` (v1) and
``_splat_v2_kernel`` (sorted tile accumulation), which are split by patch
and frame size because a TPU has no scatter.  One kernel covers any
K <= 64 and any frame here, so ``splat_supported`` / ``splat_v2_supported``
and the v1/v2 switch have no counterpart.

Bound on the card: f32 operations (four erf a patch pixel) and the atomic
units; the bytes are 20 a particle in and one image out.  Threads own
(particle, patch pixel) pairs, skip zero-amplitude particles and pixels
outside the circular mask, and ``atomicAdd`` into the image.  Float atomics
add in an order that changes from run to run, so two renders differ in the
last bits (the TPU kernels are deterministic); ``chip_smoke.py`` measures
that difference.  An ordered, tile-owned accumulation is a later design.

Plain version: ``sensor_fast._particle_splat_plain`` (re-exported here as
``splat_particles_plain``).  ``splat_particles.launches`` counts launches.
"""
from __future__ import annotations

import torch

from photon_tpu_torch import kernels
from photon_tpu_torch.ops.sensor_fast import _particle_splat_plain

splat_particles_plain = _particle_splat_plain

MAX_PATCH = 64


def splat_particles(Xs, Ys, A, col0, row0, *, K: int, ny: int, nx: int,
                    diameter: float, render_fraction: float):
    """Accumulate P erf spots into an (ny, nx) float32 image.

    Xs/Ys (P,) centre pixel coordinates, A (P,) amplitudes (already scaled
    by pi/32; zero means no deposit), col0/row0 (P,) int32 patch anchors.
    Tensors on a CUDA device go to the kernel, tensors on the CPU to the
    plain version.  Forward only: an input that requires grad raises.
    """
    if not 1 <= K <= MAX_PATCH:
        raise ValueError(f"patch side K={K} outside 1..{MAX_PATCH}")
    dev = Xs.device
    for name, t, dt in (("Xs", Xs, torch.float32), ("Ys", Ys, torch.float32),
                        ("A", A, torch.float32), ("col0", col0, torch.int32),
                        ("row0", row0, torch.int32)):
        kernels.check_kernel_input(name, t, dev, dt)
        if t.shape != Xs.shape or t.dim() != 1:
            raise ValueError(f"{name}: expected shape {tuple(Xs.shape)}, "
                             f"got {tuple(t.shape)}")
    if dev.type == "cpu":
        return _particle_splat_plain(Xs, Ys, A, col0, row0, K=K, ny=ny,
                                     nx=nx, diameter=diameter,
                                     render_fraction=render_fraction)

    image = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    P = Xs.shape[0]
    if P == 0:
        return image
    lib = kernels.load("splat")
    with torch.cuda.device(dev):
        code = lib.photon_splat(
            Xs.data_ptr(), Ys.data_ptr(), A.data_ptr(), col0.data_ptr(),
            row0.data_ptr(), image.data_ptr(), P, int(K), int(ny), int(nx),
            float(diameter), float(render_fraction * diameter),
            kernels.current_stream(dev))
    kernels.check_launch(code, "photon_splat")
    splat_particles.launches += 1
    return image


splat_particles.launches = 0
