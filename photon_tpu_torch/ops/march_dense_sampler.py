"""The per-stage slab sampler of the dense march, forward and backward.

Counterpart of ``photon_tpu/ops/march_dense_pallas.py``.
``dense_slab_sample`` returns (grad n, n-1) for P rays at voxel coordinates
``(ux, uy)`` between one pair of z slabs of the (D, H, W, 4) field, blended
linearly by ``uz``; interpolation scheme 1 is bilinear in the slab, scheme 2
the cubic B-spline over prefiltered coefficients (4 x 4 x 2 taps).  The
dense march calls it once per integrator stage on the per-stage route
(``march_dense.march_chief_per_stage``): Adams-Bashforth (algorithm 4), or
RK4 with substeps, under autograd where the stagewise kernels' residual
exceeds its budget (``march_dense_fused.traj_max_bytes``); everywhere else
the stagewise kernels of ``csrc/march_dense.cu`` and ``csrc/march_bwd.cu``
march these integrators in one launch.

Kernels: ``csrc/slab_sample.cu``.  ``photon_slab_sample`` replaces the TPU
kernel ``march_dense_pallas._fwd_kernel`` and ``photon_slab_sample_bwd``
replaces ``_bwd_kernel``.  The TPU kernels contract dense weight matrices
against the slab pair in a transposed (4W, H) layout, 1024 rays a block, with
bf16-split matrix products; here one thread owns one ray and gathers its taps
from the two (H, W, 4) slabs as they lie in the field, in f32, so there is no
``pairs_transposed`` copy, no ray blocking or padding, and no split passes.
The backward writes the coordinates' cotangents and adds the slabs'
cotangents with 16-byte float atomics (the TPU kernel sums them over its
sequential grid), so ``d_lo`` and ``d_hi`` differ in their last bits from run
to run.  Bound on the card: bytes (28 bytes a ray forward, 56 backward, plus
the slabs), which at 1e5 rays is about a microsecond, so the launch is what a
call costs.

Plain version: :func:`slab_sample_plain` and ``torch.autograd`` through it.
Tensors on the CPU go to the plain version, tensors on a CUDA device to the
kernels, at any slab size (a voxel's offset inside its slab is 32-bit: fewer
than 2^31 voxels a slab).  ``slab_sample_forward.launches`` and
``slab_sample_backward.launches`` count kernel launches, ``launches_large``
those on a slab over 256 x 256.
"""
from __future__ import annotations

import torch

from photon_tpu_torch import kernels


def check_scheme(interpolation_scheme: int) -> None:
    if interpolation_scheme not in (1, 2):
        raise ValueError(
            f"unknown interpolation_scheme {interpolation_scheme}")


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _two_tap(u, n: int):
    """Clamp-then-hat addressing: the two tap indices and weights of the
    dense hat weights ``max(0, 1 - |clip(u, 0, n-1) - i|)``."""
    uc = torch.nan_to_num(u, nan=0.0).clamp(0.0, n - 1.0)
    i0 = uc.floor().clamp(max=n - 2.0)
    f = uc - i0
    i0 = i0.long()
    return (i0, i0 + 1), (1.0 - f, f)


def _b3(x):
    """Cubic B-spline kernel B3(x), support |x| < 2."""
    ax = x.abs()
    inner = (4.0 - 6.0 * ax * ax + 3.0 * ax * ax * ax) / 6.0
    t = 2.0 - ax
    outer = t * t * t / 6.0
    return torch.where(ax < 1.0, inner,
                       torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


def _four_tap(u, n: int):
    """Cubic addressing: the coordinate clamped into [-2, n+1], four taps at
    floor(uc)-1 .. floor(uc)+2 with weight B3(uc - j), every tap's index
    clipped into [0, n-1].  Taps that clip onto a border voxel add up there,
    which is the border fold of the dense cubic weights."""
    uc = torch.nan_to_num(u, nan=-2.0).clamp(-2.0, n + 1.0)
    base = uc.floor() - 1.0
    idx, wts = [], []
    for k in range(4):
        j = base + float(k)
        wts.append(_b3(uc - j))
        idx.append(j.clamp(0.0, n - 1.0).long())
    return tuple(idx), tuple(wts)


def slab_sample_plain(lo, hi, ux, uy, uz, interpolation_scheme: int = 1):
    """(grad n, n-1) as four (P,) tensors at (P,) voxel coordinates between
    two (H, W, 4) slabs: ``lo`` weighted 1-uz, ``hi`` weighted uz."""
    check_scheme(interpolation_scheme)
    h, w, _ = lo.shape
    taps = _four_tap if interpolation_scheme == 2 else _two_tap
    ix, wx = taps(ux, w)
    iy, wy = taps(uy, h)
    lo = lo.reshape(h * w, 4)
    hi = hi.reshape(h * w, 4)
    if interpolation_scheme == 1:
        o00 = iy[0] * w + ix[0]
        o10 = o00 + w
        w00 = (wy[0] * wx[0])[:, None]
        w01 = (wy[0] * wx[1])[:, None]
        w10 = (wy[1] * wx[0])[:, None]
        w11 = (wy[1] * wx[1])[:, None]

        def blend(slab):
            return (w00 * slab[o00] + w01 * slab[o00 + 1]
                    + w10 * slab[o10] + w11 * slab[o10 + 1])
    else:
        def blend(slab):
            acc = None
            for j in range(4):
                row = iy[j] * w
                for i in range(4):
                    term = (wy[j] * wx[i])[:, None] * slab[row + ix[i]]
                    acc = term if acc is None else acc + term
            return acc

    s = (1.0 - uz)[:, None] * blend(lo) + uz[:, None] * blend(hi)
    return s[:, 0], s[:, 1], s[:, 2], s[:, 3]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_sampler_tensors(lo, hi, ux, uy, uz, interpolation_scheme, ct=None):
    """Slabs (H, W, 4), coordinates (P,), cotangent (4, P): contiguous
    float32 on one device."""
    check_scheme(interpolation_scheme)
    kernels.check_kernel_input("lo", lo, None, torch.float32)
    if lo.dim() != 3 or lo.shape[-1] != 4 or min(lo.shape[:2]) < 2:
        raise ValueError(f"lo: expected (H, W, 4) with H, W >= 2, got "
                         f"{tuple(lo.shape)}")
    check_slab_extent(lo.shape[1], lo.shape[0])
    kernels.check_kernel_input("hi", hi, lo.device, torch.float32)
    if hi.shape != lo.shape:
        raise ValueError(f"hi: expected shape {tuple(lo.shape)}, got "
                         f"{tuple(hi.shape)}")
    if ux.dim() != 1:
        raise ValueError(f"ux: expected shape (P,), got {tuple(ux.shape)}")
    for name, t in (("ux", ux), ("uy", uy), ("uz", uz)):
        kernels.check_kernel_input(name, t, lo.device, torch.float32)
        if t.shape != ux.shape:
            raise ValueError(f"{name}: expected shape {tuple(ux.shape)}, "
                             f"got {tuple(t.shape)}")
    if ct is not None:
        kernels.check_kernel_input("ct", ct, lo.device, torch.float32)
        if tuple(ct.shape) != (4, ux.shape[0]):
            raise ValueError(f"ct: expected shape {(4, ux.shape[0])}, got "
                             f"{tuple(ct.shape)}")


# slabs above this many voxels are the large tier: the march kernels'
# wrappers count their launches apart (``launches_large``) and keep a larger
# stage residual (``march_dense_fused.traj_max_bytes``)
LARGE_SLAB = 256 * 256


def large_slab(w: int, h: int) -> bool:
    return int(w) * int(h) > LARGE_SLAB


def check_slab_extent(w: int, h: int) -> None:
    """The kernels address a voxel inside its slab with a 32-bit offset
    (the slab's own offset in the field is 64-bit)."""
    if int(w) * int(h) >= 2 ** 31:
        raise ValueError(f"slab of {w} x {h} voxels: the march and sampler "
                         f"kernels take slabs of fewer than 2^31 voxels")


def count_launch(wrapper, w: int, h: int) -> None:
    wrapper.launches += 1
    if large_slab(w, h):
        wrapper.launches_large += 1


def slab_sample_forward(lo, hi, ux, uy, uz, interpolation_scheme: int = 1):
    """Launch the sampler kernel: (4, P) rows gx, gy, gz, n-1."""
    _check_sampler_tensors(lo, hi, ux, uy, uz, interpolation_scheme)
    h, w, _ = lo.shape
    P = ux.shape[0]
    out = torch.empty((4, P), dtype=torch.float32, device=lo.device)
    lib = kernels.load("slab_sample")
    with torch.cuda.device(lo.device):
        code = lib.photon_slab_sample(
            ux.data_ptr(), uy.data_ptr(), uz.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), out.data_ptr(), P, w, h,
            int(interpolation_scheme), kernels.current_stream(lo.device))
    kernels.check_launch(code, "photon_slab_sample")
    count_launch(slab_sample_forward, w, h)
    return out


def slab_sample_backward(lo, hi, ux, uy, uz, ct,
                         interpolation_scheme: int = 1):
    """Launch the sampler's backward kernel: ``(d_lo, d_hi, d_u)`` from the
    (4, P) cotangent of the sample; ``d_u`` is (3, P), rows d_ux, d_uy,
    d_uz."""
    _check_sampler_tensors(lo, hi, ux, uy, uz, interpolation_scheme, ct=ct)
    h, w, _ = lo.shape
    P = ux.shape[0]
    d_lo = torch.zeros_like(lo)
    d_hi = torch.zeros_like(hi)
    d_u = torch.empty((3, P), dtype=torch.float32, device=lo.device)
    lib = kernels.load("slab_sample")
    with torch.cuda.device(lo.device):
        code = lib.photon_slab_sample_bwd(
            ux.data_ptr(), uy.data_ptr(), uz.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), ct.data_ptr(), d_u.data_ptr(), d_lo.data_ptr(),
            d_hi.data_ptr(), P, w, h, int(interpolation_scheme),
            kernels.current_stream(lo.device))
    kernels.check_launch(code, "photon_slab_sample_bwd")
    count_launch(slab_sample_backward, w, h)
    return d_lo, d_hi, d_u


slab_sample_forward.launches = slab_sample_forward.launches_large = 0
slab_sample_backward.launches = slab_sample_backward.launches_large = 0


class _SlabSample(torch.autograd.Function):
    """The sampler on the card with its backward kernel."""

    @staticmethod
    def forward(ctx, lo, hi, ux, uy, uz, interpolation_scheme):
        ctx.scheme = interpolation_scheme
        ctx.save_for_backward(lo, hi, ux, uy, uz)
        return slab_sample_forward(lo, hi, ux, uy, uz, interpolation_scheme)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        lo, hi, ux, uy, uz = ctx.saved_tensors
        d_lo, d_hi, d_u = slab_sample_backward(lo, hi, ux, uy, uz,
                                               ct.contiguous(), ctx.scheme)
        return d_lo, d_hi, d_u[0], d_u[1], d_u[2], None


def dense_slab_sample(lo, hi, ux, uy, uz, interpolation_scheme: int = 1):
    """Sample (gx, gy, gz, n-1), four (P,) tensors, for P rays between one
    slab pair.

    ``lo`` / ``hi``: the (H, W, 4) slabs at the lower and upper z plane (of
    B-spline coefficients for scheme 2); ``ux`` / ``uy``: (P,) voxel-centre
    coordinates; ``uz``: (P,) z blend in [0, 1].  Differentiable with
    respect to all five.  Tensors on a CUDA device go to the kernels, tensors
    on the CPU to :func:`slab_sample_plain`.
    """
    if lo.device.type == "cpu":
        return slab_sample_plain(lo, hi, ux, uy, uz, interpolation_scheme)
    ux, uy, uz = (t.contiguous() for t in (ux, uy, uz))
    out = _SlabSample.apply(lo, hi, ux, uy, uz, int(interpolation_scheme))
    return tuple(out.unbind(0))
