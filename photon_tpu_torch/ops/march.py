"""Curved-ray (eikonal) marching of ray bundles, the exact path.

Counterpart of ``photon_tpu/ops/march.py`` (the reference's density-gradient
marcher, trace_rays_through_density_gradients.h), the whole menu:

* AABB entry (IntersectWithVolume :100-186), including the z-slab quirk
  (:168).  It is direction-agnostic, so rays travelling upward (a camera
  rotated by 90 degrees or more) enter from below;
* the Euler step (euler :743-950) and Sharma's RK4 (rk4 :952-1291), each
  with the stale-sample fallback and optional gradient-index noise;
* the adaptive Fehlberg RK45 (rk45 :304-718): a step size a ray, a retry
  at a tenth of it when a stage leaves the volume, a freeze below a tenth
  of the base step; the refractive index is refreshed as n = 1 + (n - 1)
  at the accepted position, where the reference assigns n - 1 (:683);
* Adams-Bashforth 4 with three RK4 steps to start it (adams_bashforth
  :1293-1453), with n = 1 + (n - 1) where the reference takes n - 1;
* :class:`_Recorder`, the per-step trajectory dump of the first rays
  (:784-790), for every algorithm;
* :func:`march_rays`, the batch in lock-step with an active mask (a frozen
  ray keeps its state bit for bit), and :func:`make_march_fn`.

The loop asks the card whether any ray is still active once every
``_CHECK_EVERY`` steps, not every step: a frozen ray does not change (under
RK45 it is neither accepted, rejected nor retried), a recorder writes NaN
for it, which its buffer already holds, so the extra steps leave every
output as it was, and the loop never passes ``max_iters``.
``differentiable=True`` runs a fixed ``num_steps`` loop with each step
under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` over
``lax.scan``), so ``torch.autograd`` reaches the field through
``field_flat``; RK45's step-size control is detached there, as the JAX
package stops its gradient.

Gradient-index noise draws its normals from a ``torch.Generator`` seeded
with ``seed`` at every call, as the JAX package draws from
``jax.random.key(seed)`` at every call; the two streams differ.  As in the
JAX package, RK45 takes no noise and Adams-Bashforth takes it only in its
three RK4 starting steps.
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


def _div(x, c: float):
    """``x / c`` divided, not multiplied by ``1 / c``: on the card PyTorch
    multiplies a tensor by the rounded reciprocal of a Python divisor, and
    the CPU divides, so the two would part by an ulp."""
    return x / torch.full_like(x, c)


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

    R_new = R + delta * (T + _div(A + 2.0 * B, 6.0))
    T_new = T + _div(A + 4.0 * B + C, 6.0)
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


def _ab4_step(state: _MarchState, T_hist, D_hist, T_n, geom: _Geom,
              sample):
    """One Adams-Bashforth-4 iteration (ref: :1293-1453, with
    n = 1 + (n - 1)).  ``T_hist`` / ``D_hist``: (3, 3, N) histories of
    n * dir and n * grad(n), oldest first; ``T_n``: (3, N).  No fallback,
    no noise."""
    pos, direction = state.pos, state.dir
    step = float(np.float32(geom.step_size))
    lookup, inb, acc = _locate(geom, pos)
    exit_now = state.active & ~inb & (state.steps != 0)
    active = state.active & ~exit_now
    branch_a = active & ~acc
    branch_b = active & acc

    val = sample(lookup)
    n = 1.0 + val[3]
    # PyTorch's ``float / tensor`` multiplies by the rounded reciprocal
    delta = torch.full_like(n, step) / n
    d24 = _div(delta, 24.0)
    D = n * val[:3]
    R_new = pos + d24 * (55.0 * T_n - 59.0 * T_hist[2]
                         + 37.0 * T_hist[1] - 9.0 * T_hist[0])
    T_new = T_n + d24 * (55.0 * D - 59.0 * D_hist[2]
                         + 37.0 * D_hist[1] - 9.0 * D_hist[0])
    dir_new = T_new / n
    dir_new = dir_new / _norm3(dir_new)

    new_pos_a = pos + float(np.float32(step) / np.float32(
        1.0 + geom.data_min)) * direction
    pos_next = torch.where(branch_b, R_new,
                           torch.where(branch_a, new_pos_a, pos))
    dir_next = torch.where(branch_b, dir_new, direction)
    T_hist_next = torch.where(branch_b, torch.stack([T_hist[1], T_hist[2],
                                                     T_n]), T_hist)
    D_hist_next = torch.where(branch_b, torch.stack([D_hist[1], D_hist[2],
                                                     D]), D_hist)
    T_next = torch.where(branch_b, T_new, T_n)
    steps_next = state.steps + branch_b.to(torch.int32)
    return (_MarchState(pos_next, dir_next, state.val_prev, state.refr,
                        active, steps_next), T_hist_next, D_hist_next, T_next)


class _Recorder:
    """Per-step trajectory recording of the first ``rays`` rays for the
    first ``steps`` iterations (the reference's intermediate ray dumps,
    ref: :784-790).  The buffers, (S, 3, n_rec) in the march's layout, hold
    NaN from the start (the reference's prefill, parallel_ray_tracing.cu
    :3541); an iteration writes at its top, and a frozen ray records NaN.
    ``finalize`` returns the reference's ray-major (n_rec, S, 3), the dump
    order ``thread_id * num_save + loop_ctr``."""

    def __init__(self, steps: int, rays: int, like: torch.Tensor):
        self.steps = int(steps)
        self.rays = int(rays)
        self.pos = torch.full((self.steps, 3, self.rays), float("nan"),
                              dtype=like.dtype, device=like.device)
        self.dir = torch.full_like(self.pos, float("nan"))

    def record(self, it: int, pos, direction, active) -> None:
        """Iteration ``it`` (a host int) of (3, N) positions and
        directions."""
        if it >= self.steps:
            return
        act = active[:self.rays]
        self.pos[it] = torch.where(act, pos[:, :self.rays], float("nan"))
        self.dir[it] = torch.where(act, direction[:, :self.rays],
                                   float("nan"))

    def finalize(self):
        return (self.pos.permute(2, 0, 1).contiguous(),
                self.dir.permute(2, 0, 1).contiguous())


def _loop(step, carry, state_of, max_iters: int, recorder=None,
          first: int = 0):
    """Run ``carry = step(carry)`` until no ray of ``state_of(carry)`` is
    active or ``max_iters`` steps are taken, asking the card once every
    ``_CHECK_EVERY`` steps; the recorder writes iteration ``first + it`` at
    the top of each step."""
    it = 0
    while it < max_iters:
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            if recorder is not None:
                st = state_of(carry)
                recorder.record(first + it, st.pos, st.dir, st.active)
            carry = step(carry)
            it += 1
        if not bool(state_of(carry).active.any()):
            break
    return carry


# ---------------------------------------------------------------------------
# RK45 (adaptive Fehlberg)
# ---------------------------------------------------------------------------

class _Rk45State(NamedTuple):
    pos: torch.Tensor        # (3, N)
    dir: torch.Tensor        # (3, N)
    h: torch.Tensor          # (N,) the ray's step
    refr: torch.Tensor       # (N,) n at the ray's position
    active: torch.Tensor     # (N,) bool


def _f32s(*cs):
    return tuple(float(np.float32(c)) for c in cs)


# Fehlberg's stage coefficients, stage s from the earlier stages, and the
# fourth- and fifth-order weights of stages (0, 2, 3, 4[, 5]); the fourth
# weight of each enters with a minus sign (the JAX package's order)
_RK45_A = ((), _f32s(1.0 / 4.0), _f32s(3.0 / 32.0, 9.0 / 32.0),
           _f32s(1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0),
           _f32s(439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0),
           _f32s(-8.0 / 27.0, 2.0, -3544.0 / 2565.0, 1859.0 / 4104.0,
                 -11.0 / 40.0))
_RK45_B4 = _f32s(25 / 216, 1408 / 2565, 2197 / 4104, 1 / 5)
_RK45_B5 = _f32s(16 / 135, 6656 / 12825, 28561 / 56430, 9 / 50, 2 / 55)


def _rk45_step(st: _Rk45State, geom: _Geom, sample) -> _Rk45State:
    """One iteration of the vectorised adaptive RK45 (ref: :304-718): six
    stages of R (position) and T = n dir, accepted where the embedded error
    estimate Rmax is within 1e-3, rejected (h shrinks) elsewhere, retried at
    h / 10 where a stage left the volume, frozen where the retry would fall
    below a tenth of the base step or the accepted position is outside.
    The step-size control is detached (the JAX package's stop_gradient):
    the schedule is data at the linearisation point."""
    tol = float(np.float32(1e-3))
    step = float(np.float32(geom.step_size))

    def fetch(p):
        lookup, inb, _ = _locate(geom, p)
        return sample(lookup), inb

    pos, direction, h, refr, active = st
    R0 = pos
    T0 = refr * direction
    ks, ls = [], []
    stage_ok = active
    for s in range(6):
        # the JAX package's Python sum: 0 + c0 k0 + c1 k1 + ...
        dR = dT = 0.0
        for c, k, l_ in zip(_RK45_A[s], ks, ls):
            dR = dR + c * k
            dT = dT + c * l_
        val, inb = fetch(R0 + dR)
        stage_ok = stage_ok & inb
        ks.append(h * (T0 + dT))
        ls.append(h * ((1.0 + val[3]) * val[:3]))

    def weighted(y0, k, b4, b5):
        y4 = y0 + b4[0] * k[0] + b4[1] * k[2] + b4[2] * k[3] - b4[3] * k[4]
        y5 = (y0 + b5[0] * k[0] + b5[1] * k[2] + b5[2] * k[3]
              - b5[3] * k[4] + b5[4] * k[5])
        return y4, y5

    y4, y5 = weighted(R0, ks, _RK45_B4, _RK45_B5)
    z4, z5 = weighted(T0, ls, _RK45_B4, _RK45_B5)
    Rmax = torch.maximum((y4 - y5).abs().amax(0),
                         (z4 - z5).abs().amax(0)) / h
    # the quarter power in float64, rounded once: the JAX package's CPU
    # pow is all but correctly rounded, PyTorch's float32 pow is not (and
    # on the CPU depends on the element's place in the vector)
    q = torch.full_like(Rmax, tol) / torch.clamp_min(
        Rmax.detach(), float(np.float32(1e-30)))
    s_fac = 0.84 * (q.double() ** 0.25).to(q.dtype)

    retry = active & ~stage_ok
    h_retry = _div(h, 10.0)
    freeze_retry = retry & (h_retry < float(np.float32(0.1)
                                            * np.float32(step)))
    accept = active & stage_ok & (Rmax <= tol)
    reject = active & stage_ok & ~accept

    new_pos = torch.where(accept, y4, pos)
    raw = z4 / refr
    nrm = torch.sqrt(torch.clamp_min(raw[0] * raw[0] + raw[1] * raw[1]
                                     + raw[2] * raw[2],
                                     float(np.float32(1e-30))))
    new_dir = torch.where(accept, raw / nrm, direction)

    # refresh n at the accepted position; freeze rays that left
    val_new, inb_new = fetch(new_pos)
    exited = accept & ~inb_new
    new_refr = torch.where(accept & inb_new, 1.0 + val_new[3], refr)
    new_h = torch.where(accept, h * torch.clamp_max(s_fac, 5.0),
                        torch.where(reject, h * torch.clamp_min(s_fac, 0.1),
                                    torch.where(retry, h_retry, h))).detach()
    return _Rk45State(new_pos, new_dir, new_h, new_refr,
                      active & ~freeze_retry & ~exited)


def march_rays(vol: DensityVolume, rays: RayBundle, *,
               algorithm: int = 2, interpolation_scheme: int = 1,
               add_ngrad_noise: bool = False, ngrad_noise_std: float = 0.0,
               seed: int = 0, max_iters: Optional[int] = None,
               differentiable: bool = False,
               num_steps: Optional[int] = None,
               field_flat=None,
               record_steps: Optional[int] = None,
               record_rays: int = 100):
    """March a ray bundle through the refractive-index volume.

    Rays outside the volume first advance to its surface
    (ref: trace_rays_through_density_gradients:1476-1506); rays that miss it
    pass through unchanged.  ``algorithm``: 1 Euler, 2 RK4, 3 adaptive RK45,
    4 Adams-Bashforth.  ``field_flat`` overrides the volume's packed field (a
    (D*H*W, 4) tensor, prefiltered for ``interpolation_scheme`` 2) so that
    gradients reach it.  ``differentiable=True``: a fixed ``num_steps`` loop,
    each step checkpointed (default: twice the volume's diagonal over the
    step size plus 16, three times plus 64 for RK45, at most 8192);
    Adams-Bashforth runs its loop either way, as in the JAX package.

    ``record_steps``: record the first ``record_steps`` iterations'
    positions and directions of the first ``record_rays`` rays (the
    reference's intermediate ray dumps, :784-790) and return ``(bundle,
    (inter_pos, inter_dir))`` with (n_rec, S, 3) tensors, NaN where a ray was
    frozen or finished; not with ``differentiable=True``."""
    if algorithm not in (1, 2, 3, 4):
        raise ValueError(f"unknown ray_tracing_algorithm {algorithm}")
    if interpolation_scheme not in (1, 2):
        raise ValueError(f"unknown interpolation_scheme "
                         f"{interpolation_scheme}")
    if record_steps is not None and differentiable:
        raise ValueError("intermediate recording is not supported on the "
                         "differentiable path")
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
    recorder = None
    if record_steps is not None:
        recorder = _Recorder(record_steps, min(int(record_rays), n_rays),
                             pos0)

    if algorithm == 3:
        # each stage checks inside_box, which excludes max_bound, so a ray
        # snapped exactly onto the entry face would retry until frozen:
        # nudge the advanced entries inside by 1e-6 of the extent, as the
        # JAX package does
        eps_b = 1e-6 * (hi - lo)
        pos0 = torch.where((outside & hit)[:, None],
                           torch.clamp(pos0, lo + eps_b, hi - eps_b), pos0)
        n0 = float(np.float32(1.000277))
        st = _Rk45State(
            pos=pos0.t().contiguous(), dir=dir0.t().contiguous(),
            h=pos0.new_full((n_rays,), float(np.float32(
                vol.step_size / 1.000277))),
            refr=pos0.new_full((n_rays,), n0),
            active=torch.ones(n_rays, dtype=torch.bool, device=dev))
        if differentiable:
            if num_steps is None:
                num_steps = int(min(3.0 * diag / vol.step_size + 64, 8192))
            for _ in range(int(num_steps)):
                st = _Rk45State(*checkpoint(
                    lambda *c: tuple(_rk45_step(_Rk45State(*c), geom,
                                                sample)),
                    *st, use_reentrant=False))
        else:
            st = _loop(lambda c: _rk45_step(c, geom, sample), st,
                       lambda c: c, max_iters, recorder)
        return _finish(rays, skip, st.pos, st.dir, recorder)

    zeros = pos0.new_zeros(n_rays)
    state = _MarchState(
        pos=pos0.t().contiguous(), dir=dir0.t().contiguous(),
        val_prev=pos0.new_zeros((4, n_rays)),
        refr=zeros + float(np.float32(1.000277)),
        active=~skip, steps=zeros.to(torch.int32))

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

    if algorithm == 4:
        state = _ab4_full(state, geom, sample, max_iters, noise_of_step,
                          recorder)
        return _finish(rays, skip, state.pos, state.dir, recorder)

    step_fn = _euler_step if algorithm == 1 else _rk4_step
    if differentiable:
        if num_steps is None:
            num_steps = int(min(2.0 * diag / vol.step_size + 16, 8192))

        def one(noise, *st):
            return tuple(step_fn(_MarchState(*st), geom, sample, noise))

        for _ in range(int(num_steps)):
            state = _MarchState(*checkpoint(one, noise_of_step(), *state,
                                            use_reentrant=False))
    else:
        state = _loop(lambda s: step_fn(s, geom, sample, noise_of_step()),
                      state, lambda s: s, max_iters, recorder)
    return _finish(rays, skip, state.pos, state.dir, recorder)


def _ab4_full(state: _MarchState, geom: _Geom, sample, max_iters: int,
              noise_of_step, recorder: Optional[_Recorder] = None):
    """Three RK4 steps that fill the histories (gradient-index noise only
    here, as in the JAX package), then the Adams-Bashforth loop
    (ref: :1293-1453); returns the final state."""
    T_list, D_list = [], []
    for i in range(3):
        val = sample(lookup_in(geom.grid, state.pos))
        n = 1.0 + val[3]
        T_list.append(n * state.dir)
        D_list.append(n * val[:3])
        if recorder is not None:
            recorder.record(i, state.pos, state.dir, state.active)
        state = _rk4_step(state, geom, sample, noise_of_step())
    val = sample(lookup_in(geom.grid, state.pos))
    carry = (state, torch.stack(T_list), torch.stack(D_list),
             (1.0 + val[3]) * state.dir)
    carry = _loop(lambda c: _ab4_step(*c, geom, sample), carry,
                  lambda c: c[0], max_iters, recorder, first=3)
    return carry[0]


def _finish(rays: RayBundle, skip, pos, direction, recorder):
    """The bundle of final (3, N) positions and directions, rays that missed
    the volume passed through, and the recording when there is one."""
    bundle = RayBundle(torch.where(skip[:, None], rays.pos, pos.t()),
                       torch.where(skip[:, None], rays.dir, direction.t()),
                       rays.wavelength, rays.radiance)
    if recorder is not None:
        return bundle, recorder.finalize()
    return bundle


def make_march_fn(vol: DensityVolume, *, algorithm: int = 2,
                  interpolation_scheme: int = 1,
                  add_ngrad_noise: bool = False,
                  ngrad_noise_std: float = 0.0, seed: int = 0,
                  differentiable: bool = False,
                  num_steps: Optional[int] = None):
    """Bind a volume into a rays -> rays marching stage for the renderer;
    the cubic scheme's coefficients are prefiltered once, here."""
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
