"""Port vs JAX: the volume's preparation (``photon_tpu_torch/native.py``,
the counterpart of ``photon_tpu/native/``) on the CPU.

The gradient precompute's plain version (``native.gradient_field_plain``,
torch float64) against the JAX package's native C++ one, bit for bit; the density
volume that both packages build from float32 and float64 rho; the plain
prefilter against the JAX package's three prefilters; the transpose's
recursion (what K12 runs) against autograd through the plain prefilter; the
forward recursion in the order K11 sums; the tiles K11 and K12 run in
(``native.prefilter_plan``: every line once, the copies' offsets, the
route); which launcher a tensor off the CPU reaches (meta tensors stand for
the card); the NRRD probe; ``device_trace``.
"""
import gzip
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu import native as jax_native
from photon_tpu.ops import interp as jax_interp
from photon_tpu.ops.march_dense import bspline_prefilter_jax
from photon_tpu.volume import build_density_volume as jax_build_volume
from photon_tpu_torch import kernels, native, volume
from photon_tpu_torch.native import (_prefilter_axis, bspline_prefilter,
                                     bspline_prefilter_plain)
from photon_tpu_torch.ops import march_dense as md
from photon_tpu_torch.ops.march_dense import march_chief_per_stage
from photon_tpu_torch.utils.nrrd_io import write_nrrd
from photon_tpu_torch.utils.profiling import device_trace

SPACINGS = (100.0, 110.0, 120.0)


def _nm1(shape, kind, seed=0):
    """float32 n-1 of a density near 1.225 kg/m^3: voxel noise or a smooth
    field."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        rho = 1.225 + 0.5 * rng.random(shape)
    else:
        x, y, z = np.meshgrid(*(np.linspace(0.0, 1.0, s) for s in shape),
                              indexing="ij")
        rho = 1.225 + 0.3 * np.sin(2.5 * x + 1.0) * np.cos(1.7 * y) \
            + 0.1 * z * z
    return (0.225e-3 * rho).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the gradient precompute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("shape", [(3, 5, 4), (17, 9, 33), (6, 3, 7)])
def test_gradient_field_plain_is_native_bit_for_bit(shape, kind):
    """Every value equal: both take float32 n-1 to double, difference and
    divide in the same order and round once (anisotropic spacings, an axis
    of 3, where every sample is a face's)."""
    nm1 = _nm1(shape, kind)
    ref = jax_native.gradient_field(nm1, SPACINGS)
    assert ref is not None
    got = native.gradient_field(torch.from_numpy(nm1), SPACINGS)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_the_stencil_refuses_an_axis_of_two():
    with pytest.raises(ValueError, match=">= 3"):
        native.gradient_field_plain(torch.zeros(4, 2, 5), SPACINGS)


def _ramp(dtype):
    """The 20 x 18 x 16 ramp rho = 1.225 + 0.01 x / 19."""
    x = np.arange(20, dtype=np.float64)[:, None, None]
    return (1.225 + 0.01 * x / 19.0 * np.ones((1, 18, 16))).astype(dtype)


def _noise(dtype):
    return (1.2 + 0.8 * np.random.default_rng(5).random((9, 11, 7))).astype(
        dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("make", [_ramp, _noise])
def test_density_volume_matches_jax(make, dtype):
    """``build_density_volume`` on the CPU against the JAX package's, which
    differentiates n-1 rounded to float32 through native (hence the
    assertion that native loads): the field bit for bit, the geometry and
    data_min equal.  With float64 rho the port differentiated float64 n-1
    before: the ramp's dn/dx sat 1.0e-4 of its maximum away, and its dn/dy
    and dn/dz, 0 in the JAX package, read 2e-22."""
    assert jax_native.available()
    rho = make(dtype)
    origin = (-1.0e3, 2.0e3, 7.5e5)
    ref = jax_build_volume(rho, SPACINGS, origin)
    got = volume.build_density_volume(rho, SPACINGS, origin, device="cpu")
    np.testing.assert_array_equal(got.field.numpy(), np.asarray(ref.field))
    for name in ("min_bound", "max_bound", "grid_spacing"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)))
    assert got.data_min == ref.data_min
    assert (got.step_size, got.max_step_size) == (ref.step_size,
                                                  ref.max_step_size)


def test_tensor_rho_gives_the_bits_of_the_array():
    """float32 rho as a tensor or as an array: the same n-1 (both round the
    Gladstone-Dale constant to float32 and multiply in float32), field and
    data_min; a float64 tensor is refused."""
    rho = _noise(np.float32)
    a = volume.build_density_volume(rho, SPACINGS, (0, 0, 0), device="cpu")
    t = volume.build_density_volume(torch.from_numpy(rho), SPACINGS,
                                    (0, 0, 0), device="cpu")
    assert torch.equal(a.field, t.field) and a.data_min == t.data_min
    with pytest.raises(TypeError, match="float32"):
        volume.build_density_volume(torch.from_numpy(rho).double(), SPACINGS,
                                    (0, 0, 0), device="cpu")


# ---------------------------------------------------------------------------
# (b) the prefilter
# ---------------------------------------------------------------------------

def _fields():
    rng = np.random.default_rng(11)
    d, h, w = np.meshgrid(np.linspace(0, 1, 12), np.linspace(0, 1, 14),
                          np.linspace(0, 1, 16), indexing="ij")
    smooth = 2.7e-4 * (1.0 + 0.05 * np.sin(3.0 * w + 2.0 * h)
                       * np.cos(d))[..., None] * np.ones(4)
    return {"random 16 x 18 x 20": rng.normal(size=(16, 18, 20, 4)),
            "smooth near 2.7e-4": smooth,
            "random 3 x 5 x 4": rng.normal(size=(3, 5, 4, 4))}


@pytest.fixture(scope="module")
def references():
    """Each field with the JAX package's three prefilters: native (C++,
    float64), the fast path's bspline_prefilter_jax (float32) and the exact
    path's ops/interp.bspline_prefilter (numpy float64)."""
    out = {}
    for name, f in _fields().items():
        f = f.astype(np.float32)
        out[name] = (f, {
            "native": jax_native.bspline_prefilter(f),
            "bspline_prefilter_jax": np.asarray(
                bspline_prefilter_jax(jnp.asarray(f))),
            "interp.bspline_prefilter": jax_interp.bspline_prefilter(f)})
    return out


@pytest.mark.parametrize("ref", ["native", "bspline_prefilter_jax",
                                 "interp.bspline_prefilter"])
@pytest.mark.parametrize("field", sorted(_fields()))
def test_prefilter_matches_the_jax_packages_prefilters(references, field,
                                                       ref):
    """Within 2e-6 of the coefficients' maximum.  The float64 prefilters sum
    the causal start down to terms of 1e-10 (native) or over the whole
    line, where the port stops at 13 terms (1e-7), and round once; the
    float32 ones round every step: the smooth field near 2.7e-4 sits
    1.23e-6 from native and 1.33e-6 from bspline_prefilter_jax, the others
    under 2.2e-7."""
    f, refs = references[field]
    got = bspline_prefilter(torch.from_numpy(f))
    err = float(np.abs(got.numpy() - refs[ref]).max()
                / np.abs(refs[ref]).max())
    print(f"{field} against {ref}: {err:.3g} of the maximum")
    assert err <= 2e-6


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("ref", ["native", "interp.bspline_prefilter"])
@pytest.mark.parametrize("field", sorted(_fields()))
def test_chip_smokes_float64_prefilter_matches_the_jax_packages(
        references, field, ref):
    """chip_smoke.prefilter_f64, which phase 14 holds K11 to at 512^3 on
    the card (2e-6 of its maximum), against the JAX package's two float64
    prefilters: within 1e-6 of the maximum.  They round their output to
    float32, and native sums the causal start down to terms of 1e-10 where
    prefilter_f64 stops at 13 terms, as the port does: the smooth field
    near 2.7e-4 reads 3.2e-7 against native, the others under 1e-7."""
    f, refs = references[field]
    got = _chip_smoke().prefilter_f64(torch.from_numpy(f)).numpy()
    err = float(np.abs(got - refs[ref]).max() / np.abs(refs[ref]).max())
    print(f"{field} against {ref}: {err:.3g} of the maximum")
    assert err <= 1e-6


def test_chip_smokes_earlier_plain_prefilter_is_the_plain_one_here():
    """chip_smoke.prefilter_stacked, the plain prefilter as it stood before
    K11 (phase 14 times it beside today's), sums the causal start over a
    stacked axis; on the CPU that order is today's for these shapes, so
    the two are bit-equal."""
    f = torch.from_numpy(np.random.default_rng(3).normal(
        size=(16, 18, 20, 4)).astype(np.float32))
    assert torch.equal(_chip_smoke().prefilter_stacked(f),
                       bspline_prefilter_plain(f))


def _k11_axis(x, axis):
    """K11's recursion along one axis, line by line as the kernel runs it:
    the causal start summed in order k = 0, 1, ..."""
    lam, z, last, zk = native.prefilter_constants(x.shape[axis])
    xs = x.movedim(axis, 0)
    n = xs.shape[0]
    acc = torch.zeros_like(xs[0])
    for k in range(len(zk)):
        acc = acc + float(zk[k]) * xs[k]
    c = [lam * acc]
    for i in range(1, n):
        c.append(lam * xs[i] + z * c[-1])
    o = [None] * n
    o[n - 1] = last * (z * c[n - 2] + c[n - 1])
    for i in range(n - 2, -1, -1):
        o[i] = z * (o[i + 1] - c[i])
    return torch.stack(o).movedim(0, axis)


def _k12_axis(g, axis):
    """K12's recursion along one axis: the transpose of _k11_axis."""
    lam, z, last, zk = native.prefilter_constants(g.shape[axis])
    gs = g.movedim(axis, 0)
    n = gs.shape[0]
    pbar = [None] * n
    u = gs[0]
    for i in range(n - 1):
        pbar[i] = -(z * u)
        u = gs[i + 1] + z * u
    pbar[n - 1] = last * u
    pbar[n - 2] = pbar[n - 2] + z * pbar[n - 1]
    xbar = [None] * n
    p = pbar[n - 1]
    for i in range(n - 1, 0, -1):
        xbar[i] = lam * p
        p = pbar[i - 1] + z * p
    t = lam * p
    xbar[0] = float(zk[0]) * t
    for k in range(1, len(zk)):
        xbar[k] = xbar[k] + float(zk[k]) * t
    return torch.stack(xbar).movedim(0, axis)


@pytest.mark.parametrize("shape", [(16, 18, 20, 4), (5, 3, 4, 1),
                                   (30, 7, 9, 4)])
def test_k11_recursion_is_the_plain_version_bit_for_bit(shape):
    """The plain version sums the causal start's terms in order k = 0, 1,
    ..., as K11 does, on every shape (PyTorch's sum over a stacked axis, which
    it took before, added in that order on the CPU only where the lines of
    an axis numbered a multiple of 32, and in another order on the card)."""
    f = torch.from_numpy(np.random.default_rng(2).normal(
        size=shape).astype(np.float32))
    want = bspline_prefilter_plain(f)
    got = f
    for axis in (0, 1, 2):
        got = _k11_axis(got, axis)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 5, 13, 20])
def test_k12_recursion_is_the_transpose(n):
    """The recursion K12 runs, in plain torch, against autograd through
    _prefilter_axis along each axis (within 1e-6 of the maximum; the same
    float32 operations), and the three axes in reverse order against
    autograd through the whole plain prefilter."""
    rng = np.random.default_rng(n)
    shape = (n, 6, 7, 2)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    for axis in range(3):
        xs = x.movedim(0, axis).contiguous()
        cts = ct.movedim(0, axis).contiguous()
        xr = xs.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(_prefilter_axis(xr, axis), xr, cts)
        got = _k12_axis(cts, axis)
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(bspline_prefilter_plain(xr), xr, ct)
    got = ct
    for axis in (2, 1, 0):
        got = _k12_axis(got, axis)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


def test_prefilter_constants_are_the_plain_versions():
    """One pole, rounded once to float32; 13 terms of the causal start,
    fewer on a shorter axis."""
    lam, z, last, zk = native.prefilter_constants(64)
    assert z == float(np.float32(np.sqrt(3.0) - 2.0))
    assert len(zk) == 13 and zk.dtype == np.float32 and zk[0] == 1.0
    assert abs(lam - 6.0) < 1e-6 and abs(last - z / (z * z - 1.0)) < 1e-7
    assert len(native.prefilter_constants(5)[3]) == 5


# ---------------------------------------------------------------------------
# (b') the tiles of K11 and K12 (native.prefilter_plan, which the launchers
# pass to csrc/volume_prep.cu)
# ---------------------------------------------------------------------------

# the card tests' shapes (tests/test_torch_cuda_kernels.py) and the bench's
_PLAN_SHAPES = [(16, 18, 20, 4), (67, 45, 129, 3), (5, 3, 4, 1),
                (8192, 2, 3, 1), (8192, 2, 3, 4), (64, 64, 64, 4),
                (512, 512, 512, 4)]


def _tile_lines(p):
    """(o, j, held) of every line slot of every tile, (tiles, rows, cols)
    each, as prefilter_tile maps block b: j-tile b % tiles_j, o-tile
    b // tiles_j; ``held``: the slot is a line of the axis."""
    tiles_j = 1 if p.cols == p.stride else -(-p.stride // p.cols)
    b = np.arange(p.tiles)[:, None, None]
    o = (b // tiles_j) * p.rows + np.arange(p.rows)[None, :, None]
    j = (b % tiles_j) * p.cols + np.arange(p.cols)[None, None, :]
    return o, j, (o < p.outer) & (j < p.stride)


@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_prefilter_plan_covers_every_line_once(shape):
    """Each axis's tiles hold every line of the axis exactly once, within
    the block (rows x cols threads) and the shared memory a block may take;
    a row's pitch puts one sample of a warp's lines in distinct banks; an
    axis whose tile would not fit takes one thread a line (axis 0 of the
    last card-test shape), every other axis the tiles."""
    for axis, p in enumerate(native.prefilter_plan(*shape)):
        assert (p.n, p.outer * p.stride) == (
            shape[axis], int(np.prod(shape)) // shape[axis])
        if not p.tiled:
            assert (shape, axis) == ((8192, 2, 3, 4), 0)
            assert p.n * min(p.stride, native.TILE_MIN_LINES) * 4 \
                > native.TILE_MAX_BYTES
            continue
        assert p.rows * p.cols <= native.TILE_THREADS
        assert p.smem_bytes == p.rows * p.pitch * 4 <= native.TILE_MAX_BYTES
        assert p.pitch >= p.n * p.cols
        assert p.cols == p.stride or (p.cols in (8, 16, 32) and p.rows == 1)
        o, j, held = _tile_lines(p)
        lines = np.sort((o * p.stride + j)[held])
        np.testing.assert_array_equal(lines, np.arange(p.outer * p.stride))
        if p.rows > 1:
            k = np.arange(min(32, p.rows * p.cols))
            for i in range(p.n):
                banks = (k // p.cols * p.pitch + i * p.cols + k % p.cols) % 32
                assert len(set(banks)) == len(k)


@pytest.mark.parametrize("shape", [(64, 64, 64, 4), (512, 512, 512, 4)])
def test_bench_shapes_take_a_warp_a_tile_in_three_tiles_an_sm(shape):
    """At the bench's shapes every axis takes tiles of 32 lines (one warp)
    in at most TILE_BYTES (three blocks an SM), copied 16 bytes a thread."""
    for p in native.prefilter_plan(*shape):
        assert p.tiled and p.rows * p.cols == 32
        assert p.smem_bytes <= native.TILE_BYTES
        assert p.cols % 4 == 0 and p.stride % 4 == 0 and p.pitch % 4 == 0


@pytest.mark.parametrize("shape", _PLAN_SHAPES[:5])
def test_tile_copies_take_every_sample_once_in_line_order(shape):
    """The offsets prefilter_tile's copies read and write (tile_unit, a
    float at a time): every element of the field once, and slot
    r * pitch + i * cols + t of a tile (line (o, j), sample i) at
    (o * n + i) * stride + j."""
    for p in native.prefilter_plan(*shape):
        if not p.tiled:
            continue
        tiles_j = 1 if p.cols == p.stride else -(-p.stride // p.cols)
        shape4 = (p.tiles, p.rows, p.n, p.cols)
        b, r, i, t = np.meshgrid(np.arange(p.tiles), np.arange(p.rows),
                                 np.arange(p.n), np.arange(p.cols),
                                 indexing="ij")
        o0, j0 = b // tiles_j * p.rows, b % tiles_j * p.cols
        o, j = o0 + r, j0 + t
        held = (o < p.outer) & (j < p.stride)
        goff = (o * p.n + i) * p.stride + j      # line (o, j), sample i
        e = i * p.cols + t                       # tile_unit's element
        base = o0 * p.n * p.stride + j0 + r * p.n * p.stride
        mapped = base + (e if p.cols == p.stride
                         else e // p.cols * p.stride + e % p.cols)
        assert mapped.shape == shape4
        np.testing.assert_array_equal(mapped[held], goff[held])
        np.testing.assert_array_equal(np.sort(goff[held]),
                                      np.arange(p.n * p.outer * p.stride))


# ---------------------------------------------------------------------------
# (b'') K10's grid (native.gradient_plan) and the index map of its kernel
# (csrc/volume_prep.cu, gradient_tile_kernel), modelled here
# ---------------------------------------------------------------------------

# the card tests' shapes (tests/test_torch_cuda_kernels.py) and the bench's
_GRADIENT_SHAPES = native.GRADIENT_EDGE_SHAPES + [
    (33, 6, 68), (64, 64, 64), (288, 288, 64), (512, 512, 512)]


def _stencil(i, n):
    """The samples grad_axis reads for index i of an axis of n."""
    return {0: (0, 1, 2), n - 1: (n - 1, n - 2, n - 3)}.get(i, (i - 1, i + 1))


def _k10_blocks(plan):
    """(z tile, x tile, y run) of each block, as the kernel maps
    blockIdx.x."""
    b = np.arange(plan.blocks)
    return (b % plan.tiles_z, b // plan.tiles_z % plan.tiles_x,
            b // (plan.tiles_z * plan.tiles_x))


@pytest.mark.parametrize("shape", _GRADIENT_SHAPES)
def test_k10_grid_writes_every_voxel_once_and_reads_inside(shape):
    """K10's blocks write every output voxel once: each (z tile, x tile, y
    run) is one block, and each axis's tiles or runs cover it once.  Each
    tile's copy (the samples its stencils reach, and the 16-byte words
    that hold them where D is a multiple of 4) lies inside the input and
    its shared memory, and holds every sample its voxels' stencils read."""
    w, h, d = shape
    plan = native.gradient_plan(w, h, d)
    assert plan.tiles_x == -(-w // 32) and plan.tiles_z == -(-d // 32)
    assert 1 <= plan.y_run <= native.GRADIENT_MAX_RUN
    assert plan.runs == -(-h // plan.y_run) and plan.blocks < 2 ** 31
    tz, tx, ty = _k10_blocks(plan)
    assert ty.max() == plan.runs - 1
    assert len(set(zip(tz, tx, ty))) == plan.blocks == \
        plan.tiles_x * plan.tiles_z * plan.runs
    for n, tiles, width, vec_ok in ((w, plan.tiles_x, 32, False),
                                    (d, plan.tiles_z, 32, d % 4 == 0),
                                    (h, plan.runs, plan.y_run, False)):
        covered = np.zeros(n, int)
        for t0, t1, lo, hi in native.gradient_spans(n, tiles, width):
            covered[t0:t1] += 1
            assert 0 <= lo <= hi <= n - 1
            for i in range(t0, t1):
                assert lo <= min(_stencil(i, n)) <= max(_stencil(i, n)) <= hi
            if width == 32:
                assert hi - lo + 1 <= native.GRADIENT_SPAN
            if vec_ok:          # the staging row of 16-byte copies
                zbase, zend = lo & ~3, (hi + 1 + 3) & ~3
                assert 0 <= zbase and zend <= n
                assert zend - zbase <= native.GRADIENT_STAGE_PITCH
        np.testing.assert_array_equal(covered, 1)


@pytest.mark.parametrize("shape", _GRADIENT_SHAPES)
def test_k10_planes_are_in_the_ring_when_a_y_plane_is_computed(shape):
    """Each y run's loop: planes reach_lo(y0) .. reach_hi(y1) enter in
    order into slot p % 3 of a ring of three; after plane p enters, the
    output planes y with reach_hi(y + 1) <= p are computed, and every
    plane their stencils read is then in the ring.  Every output plane of
    the run is computed once, and a run enters no plane outside the
    input."""
    w, h, d = shape
    plan = native.gradient_plan(w, h, d)
    done = np.zeros(h, int)
    for y0, y1, plo, phi in native.gradient_spans(h, plan.runs, plan.y_run):
        assert phi >= plo + 2           # the kernel issues two planes first
        ring, y = [None] * 3, y0
        for p in range(plo, phi + 1):
            ring[p % 3] = p
            while y < y1 and native.gradient_reach(y, y + 1, h)[1] <= p:
                assert set(_stencil(y, h)) | {y} <= set(ring)
                done[y] += 1
                y += 1
        assert y == y1
    np.testing.assert_array_equal(done, 1)


# ---------------------------------------------------------------------------
# (c) the route of a tensor off the CPU (meta tensors stand for the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("user, name", [
    (volume, "gradient_field"), (md, "bspline_prefilter"),
    (md, "bspline_prefilter_plain")])
def test_one_copy_of_each_function_lives_in_native(user, name):
    """volume and ops/march_dense take the stencil and the prefilter from
    native (one object, which dispatches on the device), and native imports
    no module of the port but kernels and the span of utils.profiling, which
    import none, so that none imports it back."""
    assert getattr(user, name) is getattr(native, name)

    def ported(module):
        with open(module.__file__) as f:
            return set(re.findall(
                r"^\s*(?:from|import) (photon_tpu_torch\S*)", f.read(), re.M))

    from photon_tpu_torch import utils
    from photon_tpu_torch.utils import profiling
    assert ported(native) == {"photon_tpu_torch",
                              "photon_tpu_torch.utils.profiling"}
    assert ported(kernels) == ported(profiling) == set()
    assert ported(utils) <= {"photon_tpu_torch.utils.nrrd_io",
                             "photon_tpu_torch.utils.tiff_io",
                             "photon_tpu_torch.utils.rng"}


class _Reached(Exception):
    pass


@pytest.fixture
def no_build(monkeypatch):
    """kernels.load raises _Reached(name); the plain versions fail the
    test if they run."""
    def load(name):
        raise _Reached(name)

    def never(*a, **k):
        raise AssertionError("a tensor off the CPU reached a plain version")

    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(native, "gradient_field_plain", never)
    monkeypatch.setattr(native, "bspline_prefilter_plain", never)


def test_card_tensor_reaches_k10(no_build):
    with pytest.raises(_Reached, match="volume_prep"):
        native.gradient_field(torch.empty(5, 4, 3, device="meta"), SPACINGS)


@pytest.mark.parametrize("rho", ["array", "tensor"])
def test_density_volume_on_the_card_reaches_k10(no_build, rho):
    rho = np.full((5, 4, 3), 1.2) if rho == "array" else torch.empty(
        5, 4, 3, device="meta")
    with pytest.raises(_Reached, match="volume_prep"):
        volume.build_density_volume(rho, SPACINGS, (0, 0, 0), device="meta")


def test_card_tensor_reaches_k11(no_build):
    assert md.bspline_prefilter is native.bspline_prefilter
    with pytest.raises(_Reached, match="volume_prep"):
        bspline_prefilter(torch.empty(4, 5, 6, 4, device="meta"))


def test_card_tensor_backward_reaches_k12(no_build, monkeypatch):
    """The forward's launcher stood in for, the backward's cotangent goes to
    K12's launcher."""
    forward = []

    def k11(field):
        forward.append(tuple(field.shape))
        return torch.empty_like(field)

    monkeypatch.setattr(native, "launch_prefilter", k11)
    f = torch.empty(4, 5, 6, 4, device="meta", requires_grad=True)
    out = bspline_prefilter(f)
    assert forward == [(4, 5, 6, 4)] and out.requires_grad
    with pytest.raises(_Reached, match="volume_prep"):
        torch.autograd.grad(out, f, torch.empty_like(out))


def test_per_stage_march_prefilters_through_k11(no_build):
    """The cubic per-stage march prefilters with bspline_prefilter (K11 on
    the card); the plain march (march_chief_dense) with the plain version
    on every device (tests/test_torch_march_menu.py)."""
    vol = volume.DensityVolume(
        field=torch.empty(4, 5, 6, 4, device="meta"),
        min_bound=np.zeros(3, np.float32),
        max_bound=np.array([5, 4, 3], np.float32),
        grid_spacing=np.ones(3, np.float32), data_min=0.0, step_size=1.0,
        max_step_size=1.0)
    rays = [torch.empty(3, device="meta") for _ in range(6)]
    with pytest.raises(_Reached, match="volume_prep"):
        march_chief_per_stage(vol, *rays, algorithm=2,
                              interpolation_scheme=2)


def _bad_calls():
    f = torch.zeros(4, 5, 6, 4)
    g = torch.zeros(6, 5, 4)
    out = {}
    for name, launch in (("K11", native.launch_prefilter),
                         ("K12", native.launch_prefilter_bwd)):
        out[f"{name}: float64"] = (lambda ln=launch: ln(f.double()))
        out[f"{name}: three axes"] = (lambda ln=launch: ln(f[..., 0]))
        out[f"{name}: an axis of 1"] = (lambda ln=launch: ln(f[:1]))
        out[f"{name}: strided"] = (lambda ln=launch: ln(f[:, :, ::2]))
    out["K10: float64"] = lambda: native.launch_gradient_field(
        g.double(), SPACINGS)
    out["K10: an axis of 2"] = lambda: native.launch_gradient_field(
        g[:, :, :2].contiguous(), SPACINGS)
    out["K10: four axes"] = lambda: native.launch_gradient_field(
        f, SPACINGS)
    out["K10: strided"] = lambda: native.launch_gradient_field(
        g.transpose(0, 2), SPACINGS)
    ct = torch.zeros(4, 5, 6, 4)
    for name, bad in (("float64", ct.double()), ("three axes", ct[..., 0]),
                      ("three channels", ct[..., :3].contiguous()),
                      ("an axis of 2", ct[:2].contiguous()),
                      ("strided", ct.transpose(0, 2))):
        out[f"K13: {name}"] = (
            lambda b=bad: native.launch_gradient_field_transpose(
                b, SPACINGS, 0.225e-3))
    return out


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_launchers_check_their_tensors_before_any_build(no_build, case):
    with pytest.raises((TypeError, ValueError)):
        _bad_calls()[case]()
    assert kernels._libs == {}


# ---------------------------------------------------------------------------
# (d) the NRRD probe and the trace context
# ---------------------------------------------------------------------------

def _nrrd_files(d):
    rng = np.random.default_rng(4)
    files = {}
    for i, shape in enumerate([(5, 4, 3), (17, 9, 33)]):
        p = os.path.join(d, f"raw{i}.nrrd")
        write_nrrd(p, rng.random(shape).astype(np.float32),
                   [10.0 + i, 20.5, 1e-3], [-1.5e5, 2.0, 7.5e5 + i])
        files[f"raw{i}"] = p
    p = os.path.join(d, "gzip.nrrd")
    with open(p, "wb") as f:
        f.write(b"NRRD0004\ntype: float\ndimension: 3\nsizes: 2 2 2\n"
                b"encoding: gzip\nspacings: 1 1 1\n\n"
                + gzip.compress(np.zeros(8, np.float32).tobytes()))
    files["gzip"] = p
    p = os.path.join(d, "double.nrrd")
    with open(p, "wb") as f:
        f.write(b"NRRD0004\r\ntype: double\r\nsizes: 2 2 2\r\n"
                b"encoding: raw\r\n\r\n" + np.zeros(8).tobytes())
    files["double"] = p
    p = os.path.join(d, "image.tif")
    with open(p, "wb") as f:
        f.write(b"II*\x00" + bytes(64))
    files["not NRRD"] = p
    files["missing"] = os.path.join(d, "missing.nrrd")
    return files


def test_nrrd_probe_matches_native(tmp_path):
    files = _nrrd_files(str(tmp_path))
    for name, path in files.items():
        got, want = native.nrrd_probe(path), jax_native.nrrd_probe(path)
        assert got == want, name
        assert (got is None) == (name not in ("raw0", "raw1")), name
    sizes, spacings, origin, offset = native.nrrd_probe(files["raw1"])
    assert sizes == (17, 9, 33) and spacings == (11.0, 20.5, 1e-3)
    with open(files["raw1"], "rb") as f:
        f.seek(offset)
        assert len(f.read()) == 17 * 9 * 33 * 4


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        torch.ones(8).cumsum(0)
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    assert [p.name for p in tmp_path.iterdir()
            if p.name.endswith(".pt.trace.json")]
