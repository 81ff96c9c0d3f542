"""The particle splat and its transpose as CUDA kernels, and their wrappers.

Forward kernel: ``csrc/splat.cu`` (``photon_splat``).  It replaces both TPU kernels
of ``photon_tpu/ops/splat_pallas.py``: ``_splat_kernel`` (v1) and
``_splat_v2_kernel`` (sorted tile accumulation), which are split by patch
and frame size because a TPU has no scatter.  One kernel covers any
K <= 64 and any frame here, so ``splat_supported`` / ``splat_v2_supported``
and the v1/v2 switch have no counterpart.

The spot is separable, so a particle's weights take one erf a row and a
column edge of its patch (K + 1 each), formed once; only the rows and columns
that the circular mask reaches are visited, each pixel with the plain
version's mask test.  What bounds it on the card is the instructions it
issues and the atomics, not bytes (20 a particle in, one image out): a warp
takes up to 32 consecutive particles, a group of lanes each for the edges
and weights, and deposits them one at a time over the warp, one float
atomic a pixel straight into the image.  Float atomics add in an order that
changes from run to run, so two renders differ in the last bits (the TPU
kernels are deterministic); ``chip_smoke.py`` measures that difference.  One
launch a call, no sort of the particles.

Backward kernel: ``photon_splat_bwd`` in the same source.  It replaces the
backward of ``photon_tpu/ops/sensor_fast.py::_particle_splat_fused`` (the
XLA transpose of the patch scatter): per particle a gather of its K x K
patch of the image's cotangent against the same separable weights and
their derivatives (an erf and an exp an edge), reduced to
``d(Xs, Ys, A)`` by the particle's group of lanes (a lane alone in a large
launch).  No atomics, so it is run-to-run equal.

Plain version: ``sensor_fast._particle_splat_plain`` (re-exported here as
``splat_particles_plain``) and ``torch.autograd`` through it.
``splat_particles.launches`` and ``splat_backward.launches`` count launches.
"""
from __future__ import annotations

import torch

from photon_tpu_torch import kernels
from photon_tpu_torch.ops.sensor_fast import _particle_splat_plain

splat_particles_plain = _particle_splat_plain

MAX_PATCH = 64


def splat_backward(Xs, Ys, A, col0, row0, ct, *, K: int, diameter: float,
                   render_fraction: float):
    """Launch the transpose kernel: (3, P) rows ``d_Xs, d_Ys, d_A`` from the
    image's cotangent ``ct`` (ny, nx)."""
    dev = ct.device
    P = Xs.shape[0]
    kernels.check_kernel_input("ct", ct, dev, torch.float32)
    if ct.dim() != 2:
        raise ValueError(f"ct: expected (ny, nx), got {tuple(ct.shape)}")
    for name, t, dt in (("Xs", Xs, torch.float32), ("Ys", Ys, torch.float32),
                        ("A", A, torch.float32), ("col0", col0, torch.int32),
                        ("row0", row0, torch.int32)):
        kernels.check_kernel_input(name, t, dev, dt)
        if tuple(t.shape) != (P,):
            raise ValueError(f"{name}: expected shape {(P,)}, got "
                             f"{tuple(t.shape)}")
    ny, nx = ct.shape
    out = torch.empty((3, P), dtype=torch.float32, device=dev)
    lib = kernels.load("splat")
    with torch.cuda.device(dev):
        code = lib.photon_splat_bwd(
            Xs.data_ptr(), Ys.data_ptr(), A.data_ptr(), col0.data_ptr(),
            row0.data_ptr(), ct.data_ptr(), out.data_ptr(), P, int(K),
            int(ny), int(nx), float(diameter),
            float(render_fraction * diameter), kernels.current_stream(dev))
    kernels.check_launch(code, "photon_splat_bwd")
    splat_backward.launches += 1
    return out


splat_backward.launches = 0


class _Splat(torch.autograd.Function):
    """(ny, nx) image on the card from P spots."""

    @staticmethod
    def forward(ctx, Xs, Ys, A, col0, row0, K, ny, nx, diameter,
                render_fraction):
        dev = Xs.device
        image = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
        lib = kernels.load("splat")
        with torch.cuda.device(dev):
            code = lib.photon_splat(
                Xs.data_ptr(), Ys.data_ptr(), A.data_ptr(), col0.data_ptr(),
                row0.data_ptr(), image.data_ptr(), Xs.shape[0], K, ny, nx,
                diameter, render_fraction * diameter,
                kernels.current_stream(dev))
        kernels.check_launch(code, "photon_splat")
        splat_particles.launches += 1
        ctx.opts = dict(K=K, diameter=diameter,
                        render_fraction=render_fraction)
        ctx.save_for_backward(Xs, Ys, A, col0, row0)
        return image

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        d = splat_backward(*ctx.saved_tensors, ct.contiguous(), **ctx.opts)
        return (d[0], d[1], d[2]) + (None,) * 7


def splat_particles(Xs, Ys, A, col0, row0, *, K: int, ny: int, nx: int,
                    diameter: float, render_fraction: float):
    """Accumulate P erf spots into an (ny, nx) float32 image.

    Xs/Ys (P,) centre pixel coordinates, A (P,) amplitudes (already scaled
    by pi/32; zero means no deposit), col0/row0 (P,) int32 patch anchors.
    Tensors on a CUDA device go to the kernels, forward and backward;
    tensors on the CPU go to the plain version and ``torch.autograd``
    through it.  Gradients flow to Xs, Ys and A.
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
    if Xs.shape[0] == 0:
        return torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    return _Splat.apply(Xs, Ys, A, col0, row0, int(K), int(ny), int(nx),
                        float(diameter), float(render_fraction))


splat_particles.launches = 0
