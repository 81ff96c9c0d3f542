"""The dense chief-ray march as CUDA kernels, forward and backward.

Forward kernel: ``csrc/march_dense.cu``.  It replaces the TPU kernel
``photon_tpu/ops/march_dense_fused.py::_fused_kernel_impl``, both heads and
both interpolation schemes.  The TPU kernel contracts dense interpolation
weights against packed slab pairs on the matrix unit; on a GPU one thread
owns one ray, keeps its state in registers through all slabs, and gathers
eight (trilinear) or thirty-two (cubic) 16-byte voxels per integrator stage
from the (D, H, W, 4) field, which an H100 serves from L2.  Bound on the card: f32 operations and dependent-load
latency for the plain head (48 bytes a ray and one pass over the field are
all the bytes it must move), bytes for the head that writes the stage
residual.  No slab packing, no block table, no padding rows, no bf16 passes.

Backward kernels: ``csrc/march_bwd.cu``.  ``photon_march_bwd_stage``
replaces ``_bwd_stage_kernel`` (the backward over the saved stage states) and
``photon_march_bwd_remarch`` replaces ``_bwd_fused_kernel`` (no residual:
each step's entry state is reconstructed from its exit state).  Both scatter
the field's cotangent with float atomics, so ``d_field`` differs in its last
bits from run to run.  Under scheme 2 the kernels read B-spline coefficients
and return the coefficients' cotangent: the prefilter
(``march_dense.bspline_prefilter``) runs in PyTorch before the kernels, on
the raw field at every call, and ``torch.autograd`` carries the cotangent
back through it.

A march whose inputs need no gradient runs the plain head
(``photon_march_dense``).  A march under autograd runs the other
instantiation of the same kernel inside a ``torch.autograd.Function``: the
same arithmetic, so bit-equal outputs, and beside them the raw exit T and
the stage residual that the backward kernels read.  The entry advance and the
final normalisation are inside the forward kernel on both routes, and the
backward kernels differentiate them by hand.  The stage residual is kept
while it fits ``TRAJ_MAX_BYTES``; above that the backward re-marches.

Dispatch on the card, as the JAX package's: Euler, RK4 and RK4 with substeps
without gradients run the plain head; Euler and RK4 under autograd run the
residual head and a backward kernel; Adams-Bashforth always, and RK4 with
substeps under autograd, run ``march_dense.march_chief_per_stage``: the plain
march's loop in PyTorch with every integrator stage sampled by the kernels of
``march_dense_sampler.py``.

Plain version: ``march_dense.march_chief_dense`` (re-exported here as
``march_chief_plain``) and ``torch.autograd`` through it.
``march_chief_fused.launches``, ``march_backward_stage.launches`` and
``march_backward_remarch.launches`` count kernel launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import kernels
from photon_tpu_torch.ops.march_dense import (bspline_prefilter,
                                              check_march_options,
                                              march_chief_dense,
                                              march_chief_per_stage,
                                              march_geometry,
                                              resolve_substeps)
from photon_tpu_torch.ops.march_dense_sampler import check_scheme
from photon_tpu_torch.volume import DensityVolume

march_chief_plain = march_chief_dense

# Stage-residual budget: while P * S * rows * 4 bytes fits, the forward saves
# every step's stage input states and the backward is the stage kernel; above
# it the backward reconstructs them by re-marching (a trade of device memory
# against time, nothing else).
TRAJ_MAX_BYTES = 2 << 30


def stage_rows(algorithm: int) -> int:
    """Floats of stage residual per ray and slab step."""
    return 5 if algorithm == 1 else 20


def defect_iterations(geom) -> int:
    """Defect corrections of the re-march backward's reverse RK4 step,
    chosen from the grid's z / lateral anisotropy: each z step spans about
    ``ratio`` lateral voxels, which sets the reverse step's truncation."""
    ratio = float(geom.dz_slab) / max(min(float(geom.sx), float(geom.sy)),
                                      1e-30)
    return 0 if ratio <= 4.0 else (1 if ratio <= 16.0 else 3)


def _check_march_tensors(field, algorithm: int, interpolation_scheme: int,
                         **tensors):
    """Field (D, H, W, 4); rays, outputs and cotangents (6, P); the raw exit
    T (3, P); the stage residual (D - 1, rows, P): contiguous float32 on the
    field's device."""
    if algorithm not in (1, 2):
        raise ValueError(f"no gradient-route kernel for algorithm {algorithm}")
    check_scheme(interpolation_scheme)
    kernels.check_kernel_input("field", field, None, torch.float32)
    if field.dim() != 4 or field.shape[-1] != 4:
        raise ValueError(f"field: expected (D, H, W, 4), got "
                         f"{tuple(field.shape)}")
    P = tensors["rays"].shape[-1]
    shapes = {"texit": (3, P),
              "traj": (field.shape[0] - 1, stage_rows(algorithm), P)}
    for name, t in tensors.items():
        kernels.check_kernel_input(name, t, field.device, torch.float32)
        want = shapes.get(name, (6, P))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(t.shape)}")


def march_forward_noresidual(field, rays, geom, algorithm: int,
                             substeps: int, interpolation_scheme: int = 1):
    """Launch the head that keeps no residual: six (P,) chief-ray tensors -> the (6, P)
    outputs of the march.  Euler, RK4, or RK4 with ``substeps``; ``field``
    holds B-spline coefficients for scheme 2 (here and in the launchers
    below)."""
    if algorithm not in (1, 2, 3):
        raise ValueError(f"no fused march kernel for algorithm {algorithm}")
    check_scheme(interpolation_scheme)
    kernels.check_kernel_input("field", field, None, torch.float32)
    if field.dim() != 4 or field.shape[-1] != 4:
        raise ValueError(f"field: expected (D, H, W, 4), got "
                         f"{tuple(field.shape)}")
    for t in rays:
        kernels.check_kernel_input("rays", t, field.device, torch.float32)
        if t.shape != rays[0].shape or t.dim() != 1:
            raise ValueError(f"rays: expected six tensors of shape "
                             f"{tuple(rays[0].shape)}, got {tuple(t.shape)}")
    d, h, w, _ = field.shape
    P = rays[0].shape[0]
    out = torch.empty((6, P), dtype=torch.float32, device=field.device)
    lib = kernels.load("march_dense")
    with torch.cuda.device(field.device):
        code = lib.photon_march_dense(
            *(t.data_ptr() for t in rays), field.data_ptr(), out.data_ptr(),
            P, w, h, d, geom.ctypes.data, int(algorithm), int(substeps),
            int(interpolation_scheme), kernels.current_stream(field.device))
    kernels.check_launch(code, "photon_march_dense")
    march_chief_fused.launches += 1
    return out


def march_forward_residual(field, rays, geom, algorithm: int,
                           save_residual: bool,
                           interpolation_scheme: int = 1):
    """Launch the gradient route's head: (6, P) chief rays ->
    ``(out, texit, traj)``: the (6, P) outputs of the march, the (3, P) raw
    exit T, and the (S, rows, P) stage residual (None unless
    ``save_residual``)."""
    _check_march_tensors(field, algorithm, interpolation_scheme, rays=rays)
    d, h, w, _ = field.shape
    P = rays.shape[1]
    out = torch.empty_like(rays)
    texit = torch.empty((3, P), dtype=torch.float32, device=rays.device)
    traj = None
    if save_residual:
        traj = torch.empty((d - 1, stage_rows(algorithm), P),
                           dtype=torch.float32, device=rays.device)
    lib = kernels.load("march_dense")
    with torch.cuda.device(rays.device):
        code = lib.photon_march_dense_grad(
            rays.data_ptr(), field.data_ptr(), out.data_ptr(),
            texit.data_ptr(), None if traj is None else traj.data_ptr(), P,
            w, h, d, geom.ctypes.data, int(algorithm),
            int(interpolation_scheme), kernels.current_stream(rays.device))
    kernels.check_launch(code, "photon_march_dense_grad")
    march_chief_fused.launches += 1
    return out, texit, traj


def march_backward_stage(field, rays, texit, traj, ct, geom, algorithm: int,
                         interpolation_scheme: int = 1):
    """Launch the stage backward kernel: ``(d_field, d_rays)`` from the
    cotangent ``ct`` (6, P) of the march's outputs."""
    _check_march_tensors(field, algorithm, interpolation_scheme, rays=rays,
                         texit=texit, traj=traj, ct=ct)
    d, h, w, _ = field.shape
    d_field = torch.zeros_like(field)
    d_rays = torch.empty_like(rays)
    lib = kernels.load("march_bwd")
    with torch.cuda.device(field.device):
        code = lib.photon_march_bwd_stage(
            rays.data_ptr(), texit.data_ptr(), traj.data_ptr(), ct.data_ptr(),
            field.data_ptr(), d_field.data_ptr(), d_rays.data_ptr(),
            rays.shape[1], w, h, d, geom.ctypes.data, int(algorithm),
            int(interpolation_scheme), kernels.current_stream(field.device))
    kernels.check_launch(code, "photon_march_bwd_stage")
    march_backward_stage.launches += 1
    return d_field, d_rays


def march_backward_remarch(field, rays, texit, out, ct, geom, algorithm: int,
                           defect_iters: int, interpolation_scheme: int = 1):
    """Launch the re-march backward kernel (no residual): as
    :func:`march_backward_stage`, from the forward's outputs ``out``."""
    _check_march_tensors(field, algorithm, interpolation_scheme, rays=rays,
                         texit=texit, out=out, ct=ct)
    d, h, w, _ = field.shape
    d_field = torch.zeros_like(field)
    d_rays = torch.empty_like(rays)
    lib = kernels.load("march_bwd")
    with torch.cuda.device(field.device):
        code = lib.photon_march_bwd_remarch(
            rays.data_ptr(), texit.data_ptr(), out.data_ptr(), ct.data_ptr(),
            field.data_ptr(), d_field.data_ptr(), d_rays.data_ptr(),
            rays.shape[1], w, h, d, geom.ctypes.data, int(algorithm),
            int(interpolation_scheme), int(defect_iters),
            kernels.current_stream(field.device))
    kernels.check_launch(code, "photon_march_bwd_remarch")
    march_backward_remarch.launches += 1
    return d_field, d_rays


march_backward_stage.launches = 0
march_backward_remarch.launches = 0


class _March(torch.autograd.Function):
    """The march on the card with its backward kernels: field (B-spline
    coefficients for scheme 2) and (6, P) chief rays -> (6, P) outputs."""

    @staticmethod
    def forward(ctx, field, rays, geom, algorithm, scheme, defect_iters,
                max_bytes):
        d = field.shape[0]
        nbytes = rays.shape[1] * (d - 1) * stage_rows(algorithm) * 4
        out, texit, traj = march_forward_residual(
            field, rays, geom, algorithm, nbytes <= max_bytes, scheme)
        ctx.geom, ctx.algorithm, ctx.scheme, ctx.defect_iters = (
            geom, algorithm, scheme, defect_iters)
        ctx.has_traj = traj is not None
        ctx.save_for_backward(field, rays, texit,
                              out if traj is None else traj)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        field, rays, texit, res = ctx.saved_tensors
        ct = ct.contiguous()
        if ctx.has_traj:
            d_field, d_rays = march_backward_stage(
                field, rays, texit, res, ct, ctx.geom, ctx.algorithm,
                ctx.scheme)
        else:
            d_field, d_rays = march_backward_remarch(
                field, rays, texit, res, ct, ctx.geom, ctx.algorithm,
                ctx.defect_iters, ctx.scheme)
        return d_field, d_rays, None, None, None, None, None


def march_chief_fused(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                      algorithm: int = 2, interpolation_scheme: int = 1,
                      substeps: Optional[int] = None):
    """March (P,) chief rays through the volume.

    Same contract as :func:`march_dense.march_chief_dense`: (P,) float32
    chief states in, ``(x, y, z, dirx, diry, dirz)`` after traversal out;
    rays that miss the volume pass through unchanged.  Tensors on a CUDA
    device go to the kernels, forward and backward; tensors on the CPU go to
    the plain version and ``torch.autograd`` through it.  Gradients flow to
    ``vol.field`` and to the rays.
    """
    check_march_options(algorithm, interpolation_scheme)
    dev = vol.field.device
    rays = (xs, ys, zs, dcx, dcy, dcz)
    names = ("xs", "ys", "zs", "dcx", "dcy", "dcz")
    kernels.check_kernel_input("vol.field", vol.field, dev, torch.float32)
    for name, t in zip(names, rays):
        kernels.check_kernel_input(name, t, dev, torch.float32)
        if t.shape != xs.shape or t.dim() != 1:
            raise ValueError(f"{name}: expected shape {tuple(xs.shape)}, "
                             f"got {tuple(t.shape)}")
    if dev.type == "cpu":
        return march_chief_dense(vol, *rays, algorithm=algorithm,
                                 interpolation_scheme=interpolation_scheme,
                                 substeps=substeps)

    P = xs.shape[0]
    substeps = resolve_substeps(algorithm, substeps)
    g = march_geometry(vol)
    geom = np.asarray(g, dtype=np.float32)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (vol.field,) + rays)
    if P == 0:
        return tuple(torch.empty((6, 0), dtype=torch.float32,
                                 device=dev).unbind(0))
    if algorithm == 4 or (needs_grad and substeps > 1):
        # no fused kernel covers these: the per-stage sampler kernels
        return march_chief_per_stage(
            vol, *rays, algorithm=algorithm,
            interpolation_scheme=interpolation_scheme, substeps=substeps)

    field = vol.field
    if interpolation_scheme == 2:
        field = bspline_prefilter(field)
    if not needs_grad:
        out = march_forward_noresidual(field, rays, geom, algorithm, substeps,
                                  interpolation_scheme)
        return tuple(out.unbind(0))

    out = _March.apply(field, torch.stack(rays), geom, int(algorithm),
                       int(interpolation_scheme), defect_iterations(g),
                       TRAJ_MAX_BYTES)
    return tuple(out.unbind(0))


march_chief_fused.launches = 0
