"""The plain reference of the cubic B-spline scheme (``interpolation_scheme``
2): the prefilter, the slab sample, the RK4 march and its backward, and the
first steps of ``invert_bos`` under it, in PyTorch alone.

Written from the published formulas, not from the program's code:

* **The prefilter** (M. Unser, "Splines: a perfect fit for signal and image
  processing", IEEE Signal Processing Magazine 16(6), 1999, Box 2; M. Unser,
  A. Aldroubi and M. Eden, IEEE Trans. Signal Processing 41(2), 1993):
  samples s[k] -> cubic B-spline coefficients c[k] along each axis in turn
  (z, y, x of a (D, H, W, C) field) by a causal and an anticausal
  first-order recursion with the pole z = sqrt(3) - 2 and the gain
  (1 - z)(1 - 1/z) = 6, in float64:
  c+[k] = 6 s[k] + z c+[k-1], c[k] = z (c[k+1] - c+[k]).
  Boundary: the mirror-symmetric (whole-sample) extension of the samples,
  started to float64's rounding: c+[0] = 6 (sum_{k<n} z^k s[k] +
  sum_{0<k<n-1} z^(2n-2-k) s[k]) / (1 - z^(2n-2)), terms of weight under
  1e-24 left out, and c[n-1] = z / (z^2 - 1) (c+[n-1] + z c+[n-2]).  The
  coefficients are rounded once to float32, the field the march reads.
* **The sample**: at voxel coordinates (ux, uy) (u = i at voxel i) each axis
  takes the coordinate clamped into [-2, n+1], its four taps floor(u) - 1 ..
  floor(u) + 2 with the cubic B-spline weights of a = u - floor(u)
  (as Ruijters et al. write them: w0 = (1-a)^3/6, w1 = (3a^3 - 6a^2
  + 4)/6, w2 = (-3a^3 + 3a^2 + 3a + 1)/6, w3 = a^3/6), and each tap's index
  clipped into [0, n-1]; the 4 x 4 taps of a slab's two coefficient planes
  are blended linearly in z by ``uz``.
* **The march**: RK4 through every slab, as :mod:`render`'s trilinear
  march, with this sample in each stage; its backward is written out as
  :mod:`render`'s is: each slab's stages recomputed from its kept entry
  state, their vector-Jacobian products in reverse (the sample's through
  the weights' derivatives), the coefficients' part added into the slab's
  two planes (equal to autograd through the same forward,
  ``tests/test_torch_cubic_invert.py``).  The prefilter's transpose is
  ``torch.autograd`` through the float64 prefilter.

Departures from photon's own cubic scheme (``cuda_codes/
CubicInterpolationCUDA``, D. Ruijters, B. ter Haar Romeny and P. Suetens,
J. Graphics Tools 13(4), 2008), all of them the port's, which this
reference follows so that it can judge the port:

1. The sample is cubic in x and y and linear in z between a slab's two
   planes of coefficients (4 x 4 x 2 taps), where the library's
   ``cubicTex3D`` is tricubic (4 x 4 x 4, eight trilinear texture
   fetches).  Since the coefficients are prefiltered along z too, the
   sample does not return the samples at the nodes of a field that varies
   in z; it does in x and y at the inner nodes.
2. The weights are float32 products of exact formulas, where the library
   blends through the texture unit's linear filter (weights held in 9-bit
   fixed point).
3. The taps past a face are clipped onto the face's voxel (constant
   extension of the coefficients), while the prefilter extends the samples
   mirror-symmetrically; so the two border nodes are not interpolated
   exactly.
4. The prefilter starts for mirror-symmetric samples, exactly in float64
   here and over 13 causal terms in float32 in the port; the library's
   ``cubicPrefilter3D`` starts its recursions for clamped samples over a
   horizon of 12 terms, in float32.

``lowp`` (the control's rounding) rounds the samples before the prefilter,
the coefficients after it and the image, as :mod:`render` rounds its field
and image.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import render as R

# float32 throughout the march and the render: no TF32 in a matrix product
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

POLE = math.sqrt(3.0) - 2.0
GAIN = (1.0 - POLE) * (1.0 - 1.0 / POLE)


# ---------------------------------------------------------------------------
# The prefilter
# ---------------------------------------------------------------------------

def _causal_start(s, n: int):
    """c+[0] / 6 of the mirror-symmetric extension of ``s`` (a sequence of
    n tensors): sum_{k<n} z^k s[k] + sum_{0<k<n-1} z^(2n-2-k) s[k], over
    1 - z^(2n-2); a term of weight under 1e-24 is under float64's
    rounding of the sum and is left out."""
    z = POLE
    acc = s[0].clone()
    for k in range(1, n):
        w = z ** k + (z ** (2 * n - 2 - k) if k < n - 1 else 0.0)
        if abs(w) >= 1e-24:
            acc = acc + w * s[k]
    return acc / (1.0 - z ** (2 * n - 2))


def prefilter_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Cubic B-spline coefficients of ``x`` along ``axis`` (x's dtype;
    differentiable: its transpose is autograd's)."""
    z = POLE
    s = x.movedim(axis, 0).unbind(0)
    n = len(s)
    if n == 1:
        return x.clone()
    causal = [GAIN * _causal_start(s, n)]
    for k in range(1, n):
        causal.append(GAIN * s[k] + z * causal[-1])
    out = [None] * n
    out[n - 1] = (z / (z * z - 1.0)) * (causal[n - 1] + z * causal[n - 2])
    for k in range(n - 2, -1, -1):
        out[k] = z * (out[k + 1] - causal[k])
    return torch.stack(out).movedim(0, axis)


def _prefilter64(field: torch.Tensor) -> torch.Tensor:
    out = field
    for axis in (0, 1, 2):
        out = prefilter_axis(out, axis)
    return out


def prefilter(field: torch.Tensor, lowp: R.Lowp = None) -> torch.Tensor:
    """(D, H, W, C) float32 samples -> float32 coefficients along z, y and
    x, computed in float64 and rounded once."""
    coeffs = _prefilter64(R._round(field, lowp).double()).to(torch.float32)
    return R._round(coeffs, lowp).contiguous()


def prefilter_transpose(ct: torch.Tensor) -> torch.Tensor:
    """The samples' cotangent from the coefficients' ``ct`` (float32 in and
    out, float64 inside): autograd through :func:`_prefilter64`, which is
    linear, so it is taken at zero."""
    with torch.enable_grad():
        x = torch.zeros(ct.shape, dtype=torch.float64, device=ct.device,
                        requires_grad=True)
        (g,) = torch.autograd.grad(_prefilter64(x), x,
                                   grad_outputs=ct.double())
    return g.to(torch.float32)


# ---------------------------------------------------------------------------
# The sample
# ---------------------------------------------------------------------------

def _axis_taps(u: torch.Tensor, n: int):
    """One axis at coordinates ``u``: the four tap indices (P, 4), their
    cubic B-spline weights (P, 4) and the weights' derivatives in ``u``
    (P, 4), zero where the clamp holds ``u``."""
    uc = torch.nan_to_num(u, nan=-2.0).clamp(-2.0, n + 1.0)
    i = uc.floor()
    a = uc - i
    b = 1.0 - a
    a2 = a * a
    a3 = a2 * a
    wts = torch.stack([b * b * b / 6.0,
                       (3.0 * a3 - 6.0 * a2 + 4.0) / 6.0,
                       (-3.0 * a3 + 3.0 * a2 + 3.0 * a + 1.0) / 6.0,
                       a3 / 6.0], 1)
    free = ((u >= -2.0) & (u <= n + 1.0)).to(u.dtype)
    d_wts = torch.stack([-0.5 * b * b, 1.5 * a2 - 2.0 * a,
                         -1.5 * a2 + a + 0.5, 0.5 * a2], 1) * free[:, None]
    base = i.long() - 1
    idx = (base[:, None] + torch.arange(4, device=u.device)[None]
           ).clamp(0, n - 1)
    return idx, wts, d_wts


def slab_sample(lo, hi, ux, uy, uz):
    """(P, 4) (gx, gy, gz, n-1) between two (H, W, 4) coefficient planes:
    the 4 x 4 cubic taps of each, ``lo`` weighted 1 - uz, ``hi`` uz; and
    what :func:`_sample_vjp` needs."""
    h, w, _ = lo.shape
    ix, wx, dwx = _axis_taps(ux, w)
    iy, wy, dwy = _axis_taps(uy, h)
    flat = (iy[:, :, None] * w + ix[:, None, :]).reshape(-1, 16)   # (P, 16)
    wt = (wy[:, :, None] * wx[:, None, :]).reshape(-1, 16, 1)
    L = lo.reshape(-1, 4)[flat]                                     # (P,16,4)
    H = hi.reshape(-1, 4)[flat]
    c = (1.0 - uz)[:, None] * (wt * L).sum(1) + uz[:, None] * (wt * H).sum(1)
    return c, (flat, wt, wx, wy, dwx, dwy, L, H, uz)


def _sample_vjp(dc, saved, d_lo, d_hi):
    """Adds the coefficients' part of ``dc`` (P, 4) into ``d_lo`` /
    ``d_hi`` (flat (H W, 4)); returns the coordinates' (d ux, d uy)."""
    flat, wt, wx, wy, dwx, dwy, L, H, uz = saved
    tap = wt * dc[:, None, :]                                       # (P,16,4)
    idx = flat.reshape(-1)
    d_lo.index_add_(0, idx, ((1.0 - uz)[:, None, None] * tap).reshape(-1, 4))
    d_hi.index_add_(0, idx, (uz[:, None, None] * tap).reshape(-1, 4))
    q = ((1.0 - uz)[:, None] * (L * dc[:, None, :]).sum(2)
         + uz[:, None] * (H * dc[:, None, :]).sum(2)).reshape(-1, 4, 4)
    d_ux = (wy[:, :, None] * dwx[:, None, :] * q).sum((1, 2))
    d_uy = (dwy[:, :, None] * wx[:, None, :] * q).sum((1, 2))
    return d_ux, d_uy


# ---------------------------------------------------------------------------
# The march (RK4, one step a slab) and its backward
# ---------------------------------------------------------------------------

def _rhs(lo, hi, g: R.Geometry, z_plane: float, S, z_at, in_band):
    """The eikonal right-hand side at state S (5, P)."""
    uz = ((z_at - z_plane) / g.dz_slab).clamp(0.0, 1.0)
    ux = 0.5 + (S[0] - g.min_x) / g.sx
    uy = 0.5 + (S[1] - g.min_y) / g.sy
    c, saved = slab_sample(lo, hi, ux, uy, uz)
    inv_tz = 1.0 / torch.where(in_band, S[4], torch.ones_like(S[4]))
    gn = (1.0 + c[:, 3]) * inv_tz
    F = torch.stack([S[2] * inv_tz, S[3] * inv_tz, gn * c[:, 0],
                     gn * c[:, 1], gn * c[:, 2]])
    return F, (saved, c, inv_tz, gn)


def _rhs_vjp(g: R.Geometry, S, a, aux, in_band, d_lo, d_hi):
    """(5, P) state cotangent of the right-hand side's cotangent ``a``."""
    saved, c, inv_tz, gn = aux
    s3 = a[2] * c[:, 0] + a[3] * c[:, 1] + a[4] * c[:, 2]
    d_inv = a[0] * S[2] + a[1] * S[3] + s3 * (1.0 + c[:, 3])
    dc = torch.stack([a[2] * gn, a[3] * gn, a[4] * gn, s3 * inv_tz], 1)
    d_ux, d_uy = _sample_vjp(dc, saved, d_lo, d_hi)
    zero = torch.zeros_like(d_inv)
    return torch.stack([d_ux / g.sx, d_uy / g.sy, a[0] * inv_tz,
                        a[1] * inv_tz,
                        torch.where(in_band, -d_inv * inv_tz * inv_tz, zero)])


def _stages(lo, hi, g, z_plane, S, z, in_band):
    hh = -(z - z_plane)
    h2 = hh / 2.0
    S1 = S
    F1, a1 = _rhs(lo, hi, g, z_plane, S1, z, in_band)
    S2 = S + h2 * F1
    F2, a2 = _rhs(lo, hi, g, z_plane, S2, z + h2, in_band)
    S3 = S + h2 * F2
    F3, a3 = _rhs(lo, hi, g, z_plane, S3, z + h2, in_band)
    S4 = S + hh * F3
    F4, a4 = _rhs(lo, hi, g, z_plane, S4, z + hh, in_band)
    new = S + (hh / 6.0) * (F1 + 2.0 * F2 + 2.0 * F3 + F4)
    return new, hh, ((S1, a1), (S2, a2), (S3, a3), (S4, a4))


def slab_step(lo, hi, g: R.Geometry, z_plane: float, S, z, inside):
    """One slab of the RK4 march: (S, z) -> (S, z) after the slab."""
    in_band = inside & (z > z_plane)
    new, _, _ = _stages(lo, hi, g, z_plane, S, z, in_band)
    return (torch.where(in_band, new, S),
            torch.where(in_band, torch.full_like(z, z_plane), z))


def _slab_vjp(lo, hi, g: R.Geometry, z_plane: float, S, z, inside, C, d_lo,
              d_hi):
    """The entry state's cotangent of one slab step, given the exit's
    ``C`` (5, P); the coefficients' part added into ``d_lo`` / ``d_hi``:
    the stages recomputed from the entry state, then their products in
    reverse."""
    in_band = inside & (z > z_plane)
    _, hh, st = _stages(lo, hi, g, z_plane, S, z, in_band)
    Cm = C * in_band
    dS = Cm.clone()
    dF = [Cm * (hh / 6.0), Cm * (hh / 3.0), Cm * (hh / 3.0), Cm * (hh / 6.0)]
    back = [None, hh / 2.0, hh / 2.0, hh]        # S_k = S + back[k] F_{k-1}
    for k in (3, 2, 1, 0):
        Sk, ak = st[k]
        gk = _rhs_vjp(g, Sk, dF[k], ak, in_band, d_lo, d_hi)
        dS = dS + gk
        if k:
            dF[k - 1] = dF[k - 1] + back[k] * gk
    return torch.where(in_band, dS, C)


def march_all(coeffs: torch.Tensor, g: R.Geometry, rays, kept=None):
    """The march through every slab of the (D, H, W, 4) coefficients
    (differentiable as written); each slab's entry state appended to
    ``kept`` where given."""
    S, z, inside = R._entry(g, *rays)
    for s, z_plane in enumerate(g.z_planes()):
        ks = g.d - 2 - s
        if kept is not None:
            kept.append((S, z))
        S, z = slab_step(coeffs[ks], coeffs[ks + 1], g, z_plane, S, z,
                         inside)
    return S, z, inside


def march_deltas(coeffs: torch.Tensor, g: R.Geometry, rays,
                 keep: bool = False):
    """Chief deltas of the rays through the coefficients; with ``keep``
    also what :func:`march_backward` needs."""
    kept = [] if keep else None
    with torch.no_grad():
        S, z, inside = march_all(coeffs, g, rays, kept)
        deltas = R._exit_deltas(S, z, inside, rays)
    return deltas, (kept, S, z, inside)


def march_backward(coeffs: torch.Tensor, g: R.Geometry, rays, tape,
                   d_deltas):
    """The coefficients' gradient of ``sum(d_deltas * deltas)``: the exit's
    derivative by autograd, then the slabs in reverse by hand."""
    kept, S_out, z_out, inside = tape
    with torch.enable_grad():
        S = S_out.detach().requires_grad_(True)
        dl = R._exit_deltas(S, z_out, inside, rays)
        (C,) = torch.autograd.grad(dl[1:], S, grad_outputs=d_deltas[1:])
    d_coeffs = torch.zeros(coeffs.shape, dtype=coeffs.dtype,
                           device=coeffs.device)
    planes = g.z_planes()
    with torch.no_grad():
        for s in range(len(planes) - 1, -1, -1):
            ks = g.d - 2 - s
            Sk, zk = kept[s]
            C = _slab_vjp(coeffs[ks], coeffs[ks + 1], g, planes[s], Sk, zk,
                          inside, C, d_coeffs[ks].view(-1, 4),
                          d_coeffs[ks + 1].view(-1, 4))
    return d_coeffs


# ---------------------------------------------------------------------------
# The render and the inversion's first steps
# ---------------------------------------------------------------------------

def render(sc: R.Scene, field: torch.Tensor, g: R.Geometry,
           lowp: R.Lowp = None) -> torch.Tensor:
    """The raw image of the scene through the (D, H, W, 4) samples
    ``field`` under the cubic scheme."""
    deltas, _ = march_deltas(prefilter(field, lowp), g, sc.chief)
    return R.image_of(sc, deltas, lowp=lowp)


def invert_steps_cubic(sc: R.Scene, g: R.Geometry, spacing,
                       gladstone_dale: float, rho0: torch.Tensor,
                       target: torch.Tensor, learning_rate: float,
                       steps: int, lowp: R.Lowp = None):
    """Losses of the first ``steps`` steps of ``invert_bos`` under the
    cubic scheme, rho after each, and the first step's gradient of the
    loss with respect to rho: ``reference/inverse.invert_steps`` with the
    prefilter after the stencil and the cubic march, each with its
    transpose in the backward."""
    rho = rho0.detach().clone()
    m = torch.zeros_like(rho)
    v = torch.zeros_like(rho)
    b1, b2, eps = 0.9, 0.999, 1e-12
    losses, rhos, first_grad = [], [], None
    for t in range(1, steps + 1):
        with torch.enable_grad():
            rho_l = rho.detach().requires_grad_(True)
            field = R.volume_from_rho(rho_l, spacing, gladstone_dale)
        coeffs = prefilter(field.detach(), lowp)
        deltas, tape = march_deltas(coeffs, g, sc.chief, keep=True)
        img = R.image_of(sc, deltas, lowp=lowp)
        diff = img - target
        loss = torch.mean(diff ** 2)
        d_img = (2.0 / diff.numel()) * diff
        d_deltas = R.deltas_backward(sc, deltas, d_img)
        del img, diff
        d_coeffs = march_backward(coeffs, g, sc.chief, tape, d_deltas)
        del tape, coeffs
        d_field = prefilter_transpose(d_coeffs)
        del d_coeffs
        (grad,) = torch.autograd.grad(field, rho_l, grad_outputs=d_field)
        del field, d_field
        if first_grad is None:
            first_grad = grad
        with torch.no_grad():
            m = b1 * m + (1 - b1) * grad
            v = b2 * v + (1 - b2) * grad * grad
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            rho = rho - learning_rate * mhat / (torch.sqrt(vhat) + eps)
        losses.append(float(loss))
        rhos.append(rho)
    return losses, rhos, first_grad
