"""The gradient precompute's transpose on the CPU: the plain version of K13
(``native.gradient_field_transpose_plain``) against the stencil it
transposes and against float64 autograd through K10's plain version; a
model of K13's grid, halo windows and rings (``csrc/volume_prep.cu``,
``gradient_transpose_kernel``); and ``inverse.volume_from_rho``'s two
routes: ``grad_axis`` under autograd for a tensor on the CPU, K10 forward
and K13 backward for one off it (meta tensors stand for the card)."""
import numpy as np
import pytest
import torch

from photon_tpu_torch import inverse, kernels, native
from photon_tpu_torch.volume import DensityVolume

SPACINGS = (100.0, 110.0, 120.0)
GD = 0.225e-3

# the card tests' shapes (tests/test_torch_cuda_kernels.py) and the bench's
_GRID_SHAPES = native.GRADIENT_EDGE_SHAPES + [
    (33, 6, 68), (64, 64, 64), (288, 288, 64), (512, 512, 512)]


def _cotangent(shape, seed=0):
    """A float64 (D, H, W, 4) cotangent for a (W, H, D) grid."""
    w, h, d = shape
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(d, h, w, 4)))


def _packed_f64(f, spacing):
    """K10's map in float64, unrounded: (W, H, D) -> (D, H, W, 4)."""
    return torch.stack([native.grad_axis(f, a, h)
                        for a, h in enumerate(spacing)] + [f],
                       dim=-1).permute(2, 1, 0, 3)


@pytest.mark.parametrize("shape", native.GRADIENT_EDGE_SHAPES)
def test_transpose_plain_is_the_stencils_transpose(shape):
    """<S x, y> = <x, S^T y> in float64 (relative 1e-12), S the packed
    stencil of grad_axis on every axis and the value itself."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape))
    y = _cotangent(shape, seed=2)
    lhs = float((_packed_f64(x, SPACINGS) * y).sum())
    rhs = float((x * native._transpose_f64(y, SPACINGS)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("shape", native.GRADIENT_EDGE_SHAPES)
def test_transpose_plain_is_float64_autograd_rounded_once(shape):
    """The plain version equals float64 autograd through K10's plain
    version of gladstone_dale * rho, rounded once to float32."""
    rho = torch.from_numpy(np.random.default_rng(3).normal(size=shape))
    rho.requires_grad_(True)
    ct = _cotangent(shape, seed=4).to(torch.float32)
    (ref,) = torch.autograd.grad(
        native.gradient_field_plain(GD * rho, SPACINGS), rho, ct)
    got = native.gradient_field_transpose(ct, SPACINGS, GD)
    assert got.dtype == torch.float32 and got.shape == shape
    assert torch.equal(got, ref.to(torch.float32))


def _treach(a, b, n):
    return native.gradient_transpose_reach(a, b, n)


def _reads(j, n):
    """The samples K13's transposed stencil reads for index j of an axis of
    n: the central rows j - 1 and j + 1, the faces' samples."""
    out = {j}
    if j >= 2:
        out.add(j - 1)
    if j <= n - 3:
        out.add(j + 1)
    if j <= 2:
        out.add(0)
    if j >= n - 3:
        out.add(n - 1)
    return out


@pytest.mark.parametrize("shape", _GRID_SHAPES)
def test_k13_grid_writes_every_voxel_once_and_reads_inside(shape):
    """K13 runs on K10's grid: each (z tile, x tile, y run) is one block,
    and its tiles and runs cover each axis once.  Each tile's window along
    x and z (gradient_transpose_reach) lies inside the grid and its
    staging row, and holds every sample its voxels' transposed stencils
    read."""
    w, h, d = shape
    plan = native.gradient_plan(w, h, d)
    assert plan.blocks == plan.tiles_x * plan.tiles_z * plan.runs < 2 ** 31
    for n, tiles in ((w, plan.tiles_x), (d, plan.tiles_z)):
        covered = np.zeros(n, int)
        for t in range(tiles):
            i0, i1 = t * native.GRADIENT_TILE, min(
                n, (t + 1) * native.GRADIENT_TILE)
            lo, hi = _treach(i0, i1, n)
            covered[i0:i1] += 1
            assert 0 <= lo <= hi <= n - 1
            assert hi - lo + 1 <= native.GRADIENT_TRANSPOSE_SPAN
            for j in range(i0, i1):
                assert lo <= min(_reads(j, n)) <= max(_reads(j, n)) <= hi
        np.testing.assert_array_equal(covered, 1)


@pytest.mark.parametrize("shape", _GRID_SHAPES)
def test_k13_planes_are_kept_when_a_y_plane_is_finished(shape):
    """Each y run: planes gradient_transpose_reach(y0, y1) enter in order,
    at least two (the kernel issues two first).  As plane p enters, a
    thread finishes output plane p - 1 where p is its central row y + 1,
    and output plane p where p + 1 is no central row; then keeps channel 1
    of p in slot p % 2 and p's in-plane sum in slot p % 2.  The central
    rows y - 1 and y + 1 a finished plane reads are then the plane in hand
    or still in their slot, and its in-plane sum is its own or still in its
    slot.  The faces' planes 0 and H - 1 come from device memory.  Every
    output plane is finished once."""
    w, h, d = shape
    plan = native.gradient_plan(w, h, d)
    done = np.zeros(h, int)
    for r in range(plan.runs):
        y0, y1 = r * plan.y_run, min(h, (r + 1) * plan.y_run)
        plo, phi = _treach(y0, y1, h)
        assert 0 <= plo and phi <= h - 1 and phi >= plo + 1
        c1, part = [None] * 2, [None] * 2
        for p in range(plo, phi + 1):
            for y in (p - 1, p):
                if not (y0 <= y < y1) or (y + 1 <= h - 2) != (y == p - 1):
                    continue
                central = {y - 1} if y >= 2 else set()
                central |= {y + 1} if y <= h - 3 else set()
                if y == p - 1:      # the slot of p - 2, and the plane p
                    assert central <= {c1[p % 2], p}
                    assert part[y % 2] == y
                else:               # the slot of p - 1
                    assert central <= {c1[(p - 1) % 2]}
                done[y] += 1
            c1[p % 2] = p
            if y0 <= p < y1:
                part[p % 2] = p
    np.testing.assert_array_equal(done, 1)


# ---------------------------------------------------------------------------
# volume_from_rho's routes
# ---------------------------------------------------------------------------

def _template(shape, device="cpu"):
    w, h, d = shape
    return DensityVolume(
        field=torch.empty((d, h, w, 4), device=device),
        min_bound=np.zeros(3, np.float32),
        max_bound=np.array(shape, np.float32),
        grid_spacing=np.asarray(SPACINGS, np.float32), data_min=0.0,
        step_size=100.0, max_step_size=120.0)


class _Reached(Exception):
    pass


@pytest.fixture
def no_build(monkeypatch):
    def load(name):
        raise _Reached(name)
    monkeypatch.setattr(kernels, "load", load)


def test_cpu_volume_from_rho_builds_its_graph_through_grad_axis(
        no_build, monkeypatch):
    """A tensor on the CPU takes grad_axis in float32 under autograd, one
    call an axis, and launches no kernel either way."""
    calls = []

    def counted(f, axis, h):
        calls.append((axis, f.dtype))
        return native.grad_axis(f, axis, h)

    monkeypatch.setattr(inverse, "grad_axis", counted)
    shape = (5, 4, 6)
    rho = torch.from_numpy(np.random.default_rng(5).normal(
        1.2, 0.1, size=shape).astype(np.float32)).requires_grad_(True)
    field = inverse.volume_from_rho(rho, _template(shape), GD).field
    assert calls == [(0, torch.float32), (1, torch.float32),
                     (2, torch.float32)]
    names = set()
    stack = [field.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None:
            names.add(type(fn).__name__)
            stack.extend(f for f, _ in fn.next_functions)
    assert "CatBackward0" in names and "StackBackward0" in names
    assert not any("StencilOnCard" in n for n in names)
    (g,) = torch.autograd.grad(field.sum(), rho)
    assert torch.isfinite(g).all()
    assert native.launch_gradient_field.launches == 0
    assert native.launch_gradient_field_transpose.launches == 0


def test_card_rho_reaches_k10_forward_and_k13_backward(no_build,
                                                        monkeypatch):
    """A tensor off the CPU reaches K10's launcher with gladstone_dale *
    rho, and its backward K13's; no grad_axis on the way."""
    monkeypatch.setattr(inverse, "grad_axis", None)
    shape = (5, 4, 6)
    rho = torch.empty(shape, device="meta", requires_grad=True)
    with pytest.raises(_Reached, match="volume_prep"):
        inverse.volume_from_rho(rho, _template(shape, "meta"), GD)
    seen = []

    def k10(n_minus_1, spacing):
        seen.append((tuple(n_minus_1.shape), list(spacing)))
        w, h, d = n_minus_1.shape
        return torch.empty((d, h, w, 4), device=n_minus_1.device)

    monkeypatch.setattr(inverse, "launch_gradient_field", k10)
    field = inverse.volume_from_rho(rho, _template(shape, "meta"), GD).field
    assert seen == [(shape, [float(np.float32(s)) for s in SPACINGS])]
    assert field.shape == (6, 4, 5, 4) and field.requires_grad
    with pytest.raises(_Reached, match="volume_prep"):
        torch.autograd.grad(field, rho, torch.empty_like(field))


def test_stencil_function_is_the_plain_pair_on_the_cpu(monkeypatch):
    """The card's autograd Function with K10 stood in for by its plain
    version: forward K10's field of gladstone_dale * rho, backward the
    plain version of K13 (what ``gradient_field_transpose`` gives a CPU
    cotangent)."""
    monkeypatch.setattr(inverse, "launch_gradient_field",
                        native.gradient_field_plain)
    shape = (33, 5, 34)
    rng = np.random.default_rng(6)
    rho = torch.from_numpy(rng.normal(1.2, 0.1, size=shape).astype(
        np.float32)).requires_grad_(True)
    sp = [float(np.float32(s)) for s in SPACINGS]
    field = inverse._StencilOnCard.apply(rho, sp, GD)
    assert torch.equal(field, native.gradient_field(GD * rho.detach(), sp))
    ct = torch.from_numpy(rng.normal(size=field.shape).astype(np.float32))
    (g,) = torch.autograd.grad(field, rho, ct)
    assert torch.equal(g, native.gradient_field_transpose_plain(ct, sp, GD))
