"""The identity the splat kernels (``csrc/splat.cu``) rest on, on the CPU.

A spot is separable, so its weights come from K + 1 edges a row and a
column of its patch, each formed once:

    t(e) = s ((anchor + e - centre) - 1/2),   s = sqrt(8) / D (f32, once)
    w(j) = erf(t(j)) - erf(t(j + 1))
    w'(j) = c (exp(-t(j)^2) - exp(-t(j + 1)^2)),   c = 2 s / sqrt(pi)

where the plain version (``_particle_splat_plain``) takes four erf a pixel
of ``sqrt(8) (f -/+ 1/2) / D``.  Here the edge form is rendered in plain
PyTorch and held to the plain image and to autograd through it (the
transpose's plain version), at the kernels' own limits on the card: 1e-5 of
the image maximum (chip_smoke's K3_TOL) and of each cotangent's maximum
(K7_TOL).  The kernels also visit only the rows and columns that the
circular mask can reach, found with a margin of 1e-3 px: the last test holds
that no pixel passing the plain version's f32 mask test lies outside them.
"""
import math

import numpy as np
import pytest
import torch

from photon_tpu_torch.ops.sensor_fast import (_particle_splat_plain,
                                              _scatter_patches)

TOL = 1e-5
RF = 0.75
NY, NX = 96, 128


def _spots(K, seed):
    """Seeded spots: dots of 40 that share their pixels, scattered spots,
    spots on the frame's edges and corners, zero-amplitude particles and
    sentinels (-1e6, A = 0), with the patch anchors the renderer gives."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, [NX, NY], (3, 2))
    X = np.concatenate([np.repeat(centres[:, 0], 40) + rng.normal(0, .4, 120),
                        rng.uniform(-0.5, NX - 0.5, 60),
                        [-0.4, NX - 0.6, 3.0, NX / 2.0, 0.0, NX - 1.0]])
    Y = np.concatenate([np.repeat(centres[:, 1], 40) + rng.normal(0, .4, 120),
                        rng.uniform(-0.5, NY - 0.5, 60),
                        [-0.4, NY - 0.6, NY - 1.0, 0.2, NY / 2.0, 0.0]])
    A = rng.uniform(0.1, 2.0, X.size) * np.pi / 32.0
    A[[5, 50, 130]] = 0.0                          # no surviving ray
    A[[7, 140, 170]] = 0.0
    X[[7, 140, 170]] = -1e6                        # the renderer's sentinel
    X, Y, A = (torch.tensor(v, dtype=torch.float32) for v in (X, Y, A))
    col0 = (torch.round(X).to(torch.int32) - K // 2).clamp(0, NX - K)
    row0 = (torch.round(Y).to(torch.int32) - K // 2).clamp(0, NY - K)
    return X, Y, A, col0, row0


def _edge_weights(anchor, centre, K, D, with_derivative):
    """(P, K) weights w (and w') from K + 1 edges, as the kernels form
    them."""
    s = np.float32(math.sqrt(8.0) / float(np.float32(D)))
    e = torch.arange(K + 1, dtype=torch.int32)
    t = torch.tensor(s) * (((anchor[:, None] + e[None]).to(torch.float32)
                            - centre[:, None]) - 0.5)
    E = torch.erf(t)
    w = E[:, :-1] - E[:, 1:]
    if not with_derivative:
        return w
    c = np.float32(2.0 / math.sqrt(math.pi) * math.sqrt(8.0)
                   / float(np.float32(D)))
    G = torch.exp(-t * t)
    return w, torch.tensor(c) * (G[:, :-1] - G[:, 1:])


def _mask(X, Y, col0, row0, K, D):
    """(P, K, K) [row, col]: the plain version's circle test."""
    ar = torch.arange(K, dtype=torch.int32)
    fc = (col0[:, None] + ar[None]).to(torch.float32) - X[:, None]
    fr = (row0[:, None] + ar[None]).to(torch.float32) - Y[:, None]
    rf_d = torch.tensor(RF * D, dtype=torch.float32)
    return (fc[:, None, :] ** 2 + fr[:, :, None] ** 2) <= rf_d * rf_d


def _edge_splat(X, Y, A, col0, row0, K, D):
    wx = _edge_weights(col0, X, K, D, False)
    wy = _edge_weights(row0, Y, K, D, False) * A[:, None]
    patches = wy[:, :, None] * wx[:, None, :]
    patches = torch.where(_mask(X, Y, col0, row0, K, D), patches,
                          torch.zeros_like(patches))
    return _scatter_patches(patches, col0, row0, NX, NY)


def _edge_transpose(X, Y, A, col0, row0, ct, K, D):
    """d(X, Y, A) from the image's cotangent, the sums of the transpose
    kernel: a gather of the patch against the edge weights."""
    wx, dwx = _edge_weights(col0, X, K, D, True)
    wy, dwy = _edge_weights(row0, Y, K, D, True)
    ar = torch.arange(K, dtype=torch.int64)
    cols = col0.to(torch.int64)[:, None, None] + ar[None, None, :]
    rows = row0.to(torch.int64)[:, None, None] + ar[None, :, None]
    on = (cols >= 0) & (cols < NX) & (rows >= 0) & (rows < NY) \
        & _mask(X, Y, col0, row0, K, D)
    flat = (rows * NX + cols).clamp(0, NY * NX - 1)
    g = torch.where(on, ct.reshape(-1)[flat], torch.zeros(()))
    dA = (g * wy[:, :, None] * wx[:, None, :]).sum((1, 2))
    dX = -A * (g * wy[:, :, None] * dwx[:, None, :]).sum((1, 2))
    dY = -A * (g * dwy[:, :, None] * wx[:, None, :]).sum((1, 2))
    return dX, dY, dA


def _nerr(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# patch sides 6..40; diameters up to the largest whose mask the patch holds
# (auto_patch: K >= 1.5 D + 3) and one whose mask the patch clips
CASES = [(6, 1.5), (6, 2.0), (6, 4.0), (8, 2.5), (8, 3.3), (12, 4.0),
         (12, 6.0), (20, 8.0), (20, 11.0), (40, 15.0), (40, 24.0)]


@pytest.mark.parametrize("K,D", CASES)
def test_edge_form_matches_the_plain_splat(K, D):
    X, Y, A, col0, row0 = _spots(K, seed=K)
    ref = _particle_splat_plain(X, Y, A, col0, row0, K=K, ny=NY, nx=NX,
                                diameter=D, render_fraction=RF)
    got = _edge_splat(X, Y, A, col0, row0, K, D)
    assert float(ref.max()) > 0
    assert float((got - ref).abs().max() / ref.max()) <= TOL


@pytest.mark.parametrize("K,D", CASES)
def test_edge_form_matches_autograd_through_the_plain_splat(K, D):
    X, Y, A, col0, row0 = _spots(K, seed=100 + K)
    ct = torch.tensor(np.random.default_rng(K).standard_normal((NY, NX)),
                      dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (X, Y, A)]
    img = _particle_splat_plain(*leaves, col0, row0, K=K, ny=NY, nx=NX,
                                diameter=D, render_fraction=RF)
    ref = torch.autograd.grad(img, leaves, grad_outputs=ct)
    got = _edge_transpose(X, Y, A, col0, row0, ct, K, D)
    for g, r in zip(got, ref):
        assert float(r.abs().max()) > 0
        assert _nerr(g, r) <= TOL
    # the sentinels and zero-amplitude particles: nothing to move
    assert float(got[0][[7, 140, 170]].abs().max()) == 0.0


@pytest.mark.parametrize("K,D", CASES)
def test_masked_pixels_lie_in_the_visited_rows_and_columns(K, D):
    """The kernels visit columns ceil(x - rf D - 1e-3) .. floor(x + rf D +
    1e-3) of the patch (rows alike): every pixel that passes the f32 circle
    test is among them, also for centres an ulp from a pixel's distance."""
    X, Y, A, col0, row0 = _spots(K, seed=200 + K)
    rng = np.random.default_rng(K)
    # centres at exactly rf D (and an ulp off) from a pixel along an axis
    r = np.float32(RF * D)
    edge = np.float32(40.0) + r
    X[:12] = torch.tensor(np.repeat([np.nextafter(edge, 0, dtype=np.float32),
                                     edge, np.nextafter(edge, 99,
                                                        dtype=np.float32)],
                                    4))
    Y[:12] = 50.0                                  # on a pixel row
    X[12:20] = torch.tensor(rng.uniform(0, NX, 8).astype(np.float32))
    col0 = (torch.round(X).to(torch.int32) - K // 2).clamp(0, NX - K)
    row0 = (torch.round(Y).to(torch.int32) - K // 2).clamp(0, NY - K)
    rf_d = float(np.float32(RF * D))
    ar = torch.arange(K, dtype=torch.int32)
    cols = (col0[:, None] + ar[None])
    rows = (row0[:, None] + ar[None])
    lo_c = torch.ceil(X - rf_d - 1e-3).to(torch.int32)[:, None]
    hi_c = torch.floor(X + rf_d + 1e-3).to(torch.int32)[:, None]
    lo_r = torch.ceil(Y - rf_d - 1e-3).to(torch.int32)[:, None]
    hi_r = torch.floor(Y + rf_d + 1e-3).to(torch.int32)[:, None]
    in_c = (cols >= lo_c) & (cols <= hi_c)
    in_r = (rows >= lo_r) & (rows <= hi_r)
    visited = in_r[:, :, None] & in_c[:, None, :]
    passes = _mask(X, Y, col0, row0, K, D)
    assert bool(passes.any())
    assert not bool((passes & ~visited).any())
