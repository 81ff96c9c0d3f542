"""Curved-ray (eikonal) marching of ray bundles, the exact path.

Counterpart of ``photon_tpu/ops/march.py`` (the reference's density-gradient
marcher, trace_rays_through_density_gradients.h), for algorithms 1 and 2:

* AABB entry (IntersectWithVolume :100-186), including the z-slab quirk
  (:168).  It is direction-agnostic, so rays travelling upward (a camera
  rotated by 90 degrees or more) enter from below;
* the Euler step (euler :743-950) and Sharma's RK4 (rk4 :952-1291), each
  with the stale-sample fallback and optional gradient-index noise;
* :func:`march_rays`, the batch in lock-step with an active mask (a frozen
  ray keeps its state bit for bit), and :func:`make_march_fn`.

The loop asks the card whether any ray is still active once every
``_CHECK_EVERY`` steps, not every step: a frozen ray does not change, so the
extra steps leave every output as it was, and the loop never passes
``max_iters``.  ``differentiable=True`` runs a fixed ``num_steps`` loop with
each step under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint`` over ``lax.scan``), so ``torch.autograd`` reaches the
field through ``field_flat``.

Gradient-index noise draws its normals from a ``torch.Generator`` seeded
with ``seed`` at every call, as the JAX package draws from
``jax.random.key(seed)`` at every call; the two streams differ.

The adaptive RK45 (algorithm 3), Adams-Bashforth (algorithm 4) and the
per-step recording of the ray dumps are the exact path's slice B and raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from photon_tpu_torch.device import as_f32
from photon_tpu_torch.ops.interp import (Grid, accessible_in, inside_in,
                                         lookup_in, make_grid, tricubic_in,
                                         trilinear_in)
from photon_tpu_torch.ops.lens import RayBundle
from photon_tpu_torch.ops.march_dense import bspline_prefilter
from photon_tpu_torch.roadmap import SLICE_B, later
from photon_tpu_torch.volume import DensityVolume

# steps between two host reads of "is any ray still active"
_CHECK_EVERY = 16


def aabb_entry(pos, direction, min_bound, max_bound):
    """Advance rays starting outside the volume to its surface.

    The vectorised slab test of the reference's IntersectWithVolume
    (ref: :100-186), including its quirk that the z slab only advances
    ``tnear`` for a non-negative ``t1``.  ``min_bound`` / ``max_bound``:
    (3,) tensors.  Returns (new_pos, hit_mask)."""
    big = float(np.float32(3.4e38))
    tnear = torch.full(pos.shape[:-1], -big, dtype=pos.dtype,
                       device=pos.device)
    tfar = torch.full(pos.shape[:-1], big, dtype=pos.dtype,
                      device=pos.device)
    miss = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for axis in range(3):
        t1 = (min_bound[axis] - pos[..., axis]) / direction[..., axis]
        t2 = (max_bound[axis] - pos[..., axis]) / direction[..., axis]
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        if axis == 2:
            # z-slab quirk (ref: :168): tnear only advances if lo >= 0
            tnear = torch.where((lo >= 0) & (lo > tnear), lo, tnear)
        else:
            tnear = torch.maximum(tnear, lo)
        tfar = torch.minimum(tfar, hi)
        miss = miss | (tnear > tfar) | (tfar < 0.0)
    t = torch.where(tnear < 0.0, tfar, tnear)
    new_pos = pos + direction * t[..., None]
    return torch.where(miss[..., None], pos, new_pos), ~miss


class _MarchState(NamedTuple):
    """The batch's state, component-major: rows are x, y, z (and n - 1)."""
    pos: torch.Tensor        # (3, N)
    dir: torch.Tensor        # (3, N)
    val_prev: torch.Tensor   # (4, N) last committed field sample (n - 1 last)
    refr: torch.Tensor       # (N,) running refractive index (Euler only)
    active: torch.Tensor     # (N,) bool
    steps: torch.Tensor      # (N,) int32 committed step count


class _Geom(NamedTuple):
    """What the step bodies close over: the volume's sampling grid (its
    constants as tensors on the rays' device, ``ops/interp.Grid``), the
    unit z shift of the fallback, and Python scalars."""
    grid: Grid
    e_z: torch.Tensor       # (3, 1) (0, 0, 1)
    data_min: float
    step_size: float
    interpolation_scheme: int


def _make_sampler(geom: _Geom, field_t):
    """(4, N) samples at (3, N) lookups of the channel-major field
    (4, D*H*W)."""
    if geom.interpolation_scheme == 2:
        return lambda lookup: tricubic_in(geom.grid, field_t, lookup)
    return lambda lookup: trilinear_in(geom.grid, field_t, lookup)


def _locate(geom: _Geom, pos):
    """(lookup, inside_box, can_access) of positions (3, N)."""
    lookup = lookup_in(geom.grid, pos)
    acc = accessible_in(geom.grid, lookup)
    return lookup, inside_in(geom.grid, pos, acc), acc


def _apply_fallback(val, val_prev, refr, sample, lookup, data_min: float,
                    e_z):
    """The reference's stale-sample fallback when the fetched (n-1) dips
    below the volume minimum (ref: euler :834-845 / rk4 :1056-1065): reuse
    the previous sample, or on the first step refetch one z slab back and
    substitute the running refractive index.  The refetch samples the whole
    batch: a subset would need its size on the host."""
    need = val[3] < data_min
    first = need & (val_prev[3] == 0.0)
    shifted = sample(lookup - e_z)
    fb_first = torch.cat([shifted[:3], (refr - 1.0)[None]])
    return torch.where(first, fb_first, torch.where(need, val_prev, val))


def _noisy(grad, noise):
    """Gradient-index noise on x and y: ``noise`` is (2, N) normals scaled
    by the std, or None."""
    if noise is None:
        return grad
    return torch.cat([grad[:2] + noise, grad[2:]])


def _norm3(v):
    """The length of each column of (3, N), summed x, y, z."""
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _euler_step(state: _MarchState, geom: _Geom, sample, noise=None):
    """One iteration of the reference's Euler while loop (ref: :772-893)."""
    pos, direction = state.pos, state.dir
    lookup, inb, acc = _locate(geom, pos)
    exit_now = state.active & ~inb & (state.steps != 0)
    active = state.active & ~exit_now

    branch_a = active & ~acc          # advance without field access
    branch_b = active & acc

    val = sample(lookup)
    val = _apply_fallback(val, state.val_prev, state.refr, sample, lookup,
                          geom.data_min, geom.e_z)
    cur_n = 1.0 + val[3]
    grad = _noisy(val[:3], noise)

    step = float(np.float32(geom.step_size))
    new_dir = direction + step * grad
    new_pos_b = pos + (step / cur_n) * new_dir
    new_pos_a = pos + float(np.float32(step) / np.float32(
        1.0 + geom.data_min)) * direction

    pos_next = torch.where(branch_b, new_pos_b,
                           torch.where(branch_a, new_pos_a, pos))
    dir_next = torch.where(branch_b, new_dir, direction)
    refr_next = torch.where(branch_b, cur_n, state.refr)
    val_prev_next = torch.where(branch_b, val, state.val_prev)
    steps_next = state.steps + branch_b.to(torch.int32)
    return _MarchState(pos_next, dir_next, val_prev_next, refr_next, active,
                       steps_next)


def _rk4_step(state: _MarchState, geom: _Geom, sample, noise=None):
    """One iteration of the reference's RK4 while loop (ref: :997-1180):
    Sharma's R/T formulation (R = position, T = n * dir), three field
    fetches a step with boundary checks that freeze the ray mid-step
    without committing."""
    pos, direction = state.pos, state.dir
    step = float(np.float32(geom.step_size))

    lookup1, inb1, acc = _locate(geom, pos)
    exit_now = state.active & ~inb1 & (state.steps != 0)
    active = state.active & ~exit_now

    branch_a = active & ~acc
    branch_b = active & acc

    val1 = sample(lookup1)
    val1 = _apply_fallback(val1, state.val_prev, state.refr, sample, lookup1,
                           geom.data_min, geom.e_z)
    n1 = 1.0 + val1[3]
    grad1 = _noisy(val1[:3], noise)

    R = pos
    delta = step / n1
    T = n1 * direction
    D1 = n1 * grad1
    A = delta * D1

    pos2 = R + delta / 2.0 * T + delta * A / 8.0
    lookup2, inb2, _ = _locate(geom, pos2)
    die2 = branch_b & ~inb2

    val2 = sample(lookup2)
    val2 = _apply_fallback(val2, val1, state.refr, sample, lookup2,
                           geom.data_min, geom.e_z)
    n2 = 1.0 + val2[3]
    B = delta * (n2 * val2[:3])

    pos3 = R + delta * T + delta * B / 2.0
    lookup3, inb3, _ = _locate(geom, pos3)
    die3 = branch_b & inb2 & ~inb3

    val3 = sample(lookup3)
    val3 = _apply_fallback(val3, val2, state.refr, sample, lookup3,
                           geom.data_min, geom.e_z)
    n3 = 1.0 + val3[3]
    C = delta * (n3 * val3[:3])

    R_new = R + delta * (T + (A + 2.0 * B) / 6.0)
    T_new = T + (A + 4.0 * B + C) / 6.0
    dir_new = T_new / n1
    dir_new = dir_new / _norm3(dir_new)

    commit = branch_b & inb2 & inb3
    new_pos_a = pos + float(np.float32(step) / np.float32(
        1.0 + geom.data_min)) * direction

    pos_next = torch.where(commit, R_new,
                           torch.where(branch_a, new_pos_a, pos))
    dir_next = torch.where(commit, dir_new, direction)
    val_prev_next = torch.where(commit, val3, state.val_prev)
    steps_next = state.steps + commit.to(torch.int32)
    active_next = active & ~die2 & ~die3
    return _MarchState(pos_next, dir_next, val_prev_next, state.refr,
                       active_next, steps_next)


def march_rays(vol: DensityVolume, rays: RayBundle, *,
               algorithm: int = 2, interpolation_scheme: int = 1,
               add_ngrad_noise: bool = False, ngrad_noise_std: float = 0.0,
               seed: int = 0, max_iters: Optional[int] = None,
               differentiable: bool = False,
               num_steps: Optional[int] = None,
               field_flat=None,
               record_steps: Optional[int] = None,
               record_rays: int = 100) -> RayBundle:
    """March a ray bundle through the refractive-index volume.

    Rays outside the volume first advance to its surface
    (ref: trace_rays_through_density_gradients:1476-1506); rays that miss it
    pass through unchanged.  ``field_flat`` overrides the volume's packed
    field (a (D*H*W, 4) tensor, prefiltered for ``interpolation_scheme`` 2)
    so that gradients reach it.  ``differentiable=True``: a fixed
    ``num_steps`` loop (default: twice the volume's diagonal over the step
    size, plus 16, at most 8192), each step checkpointed.
    ``algorithm`` 3 and 4 and ``record_steps`` raise (slice B)."""
    if algorithm in (3, 4):
        raise later(f"algorithm {algorithm} on the exact path "
                    f"({'RK45' if algorithm == 3 else 'Adams-Bashforth'})",
                    SLICE_B)
    if algorithm not in (1, 2):
        raise ValueError(f"unknown ray_tracing_algorithm {algorithm}")
    if interpolation_scheme not in (1, 2):
        raise ValueError(f"unknown interpolation_scheme "
                         f"{interpolation_scheme}")
    if record_steps is not None:
        raise later("record_steps (the per-step ray dumps)", SLICE_B)
    dev = rays.pos.device
    if vol.field.device != dev:
        raise ValueError(f"volume on {vol.field.device}, rays on {dev}")
    lo = as_f32(vol.min_bound, dev)
    hi = as_f32(vol.max_bound, dev)
    geom = _Geom(grid=make_grid(vol.sizes, lo, hi),
                 e_z=torch.tensor((0.0, 0.0, 1.0)).reshape(3, 1).to(dev),
                 data_min=float(vol.data_min),
                 step_size=float(vol.step_size),
                 interpolation_scheme=int(interpolation_scheme))
    if field_flat is None:
        field = vol.field
        if interpolation_scheme == 2:
            field = bspline_prefilter(field)
        field_flat = field.reshape(-1, 4)
    # the samplers gather from the field channel by channel (ops/interp.py)
    sample = _make_sampler(geom, field_flat.t().contiguous())

    pos0, dir0 = rays.pos, rays.dir
    # entry: advance outside-the-box rays to the surface
    outside = ((pos0 <= lo) | (pos0 >= hi)).any(-1)
    entered, hit = aabb_entry(pos0, dir0, lo, hi)
    pos0 = torch.where(outside[:, None], entered, pos0)
    skip = outside & ~hit     # missed the volume entirely: pass through

    diag = float(np.linalg.norm(np.asarray(vol.max_bound)
                                - np.asarray(vol.min_bound)))
    if max_iters is None:
        max_iters = int(min(4.0 * diag / vol.step_size + 64, 100000))

    n_rays = pos0.shape[0]
    zeros = pos0.new_zeros(n_rays)
    state = _MarchState(
        pos=pos0.t().contiguous(), dir=dir0.t().contiguous(),
        val_prev=pos0.new_zeros((4, n_rays)),
        refr=zeros + float(np.float32(1.000277)),
        active=~skip, steps=zeros.to(torch.int32))
    step_fn = _euler_step if algorithm == 1 else _rk4_step

    gen = None
    if add_ngrad_noise:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

    def noise_of_step():
        if gen is None:
            return None
        return torch.randn((2, n_rays), generator=gen, device=dev,
                           dtype=pos0.dtype) * float(
            np.float32(ngrad_noise_std))

    if differentiable:
        if num_steps is None:
            num_steps = int(min(2.0 * diag / vol.step_size + 16, 8192))

        def one(noise, *st):
            return tuple(step_fn(_MarchState(*st), geom, sample, noise))

        for _ in range(int(num_steps)):
            state = _MarchState(*checkpoint(one, noise_of_step(), *state,
                                            use_reentrant=False))
    else:
        it = 0
        while it < max_iters:
            for _ in range(min(_CHECK_EVERY, max_iters - it)):
                state = step_fn(state, geom, sample, noise_of_step())
            it += _CHECK_EVERY
            if not bool(state.active.any()):
                break

    pos_f = torch.where(skip[:, None], rays.pos, state.pos.t())
    dir_f = torch.where(skip[:, None], rays.dir, state.dir.t())
    return RayBundle(pos_f, dir_f, rays.wavelength, rays.radiance)


def make_march_fn(vol: DensityVolume, *, algorithm: int = 2,
                  interpolation_scheme: int = 1,
                  add_ngrad_noise: bool = False,
                  ngrad_noise_std: float = 0.0, seed: int = 0,
                  differentiable: bool = False,
                  num_steps: Optional[int] = None):
    """Bind a volume into a rays -> rays marching stage for the renderer;
    the cubic scheme's coefficients are prefiltered once, here."""
    if algorithm in (3, 4):
        raise later(f"algorithm {algorithm} on the exact path", SLICE_B)
    field = vol.field
    if interpolation_scheme == 2:
        field = bspline_prefilter(field)
    field_flat = field.reshape(-1, 4)

    def march(rays: RayBundle, field_override=None) -> RayBundle:
        return march_rays(
            vol, rays, algorithm=algorithm,
            interpolation_scheme=interpolation_scheme,
            add_ngrad_noise=add_ngrad_noise,
            ngrad_noise_std=ngrad_noise_std, seed=seed,
            differentiable=differentiable, num_steps=num_steps,
            field_flat=(field_override if field_override is not None
                        else field_flat))

    return march
