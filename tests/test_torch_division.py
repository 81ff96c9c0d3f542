"""The kernels' division by a shared divisor (csrc/div_rn.cuh): a product
with the correctly rounded reciprocal and one FMA correction return the
IEEE float32 quotient, bit for bit, on the divisors of the bench scene, for
every significand of the numerator.

The FMAs are emulated exactly: every operation is carried out on
fractions and rounded once to float32 (to nearest, ties to even), and, for
the sweep over all 2^23 significands, in float64 where that is exact and
by an exact two-sum where it is not."""
import math
import pathlib
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from photon_tpu_torch.ops.fan import f32_reciprocal

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rn32(x: Fraction) -> np.float32:
    """x rounded once to float32, to nearest with ties to even."""
    if x == 0:
        return np.float32(0.0)
    sign, a = (-1 if x < 0 else 1), abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1                                   # 2^e <= a < 2^(e+1)
    e = max(e, -126)                             # subnormals: fixed scale
    scaled = a / Fraction(2) ** (e - 23)         # 24 bits above the point
    q, r = divmod(scaled.numerator, scaled.denominator)
    if 2 * r > scaled.denominator or (2 * r == scaled.denominator and q & 1):
        q += 1
    val = q * Fraction(2) ** (e - 23)
    if val >= Fraction(2) ** 128:
        return np.float32(sign * math.inf)
    return np.float32(sign * float(val))


def f(v) -> Fraction:
    return Fraction(float(v))


def div_rn_by(a, b, inv_b):
    """div_rn.cuh: q = RN(a inv_b); e = RN(a - q b); RN(q + e inv_b)."""
    q = rn32(f(a) * f(inv_b))
    e = rn32(f(a) - f(q) * f(b))
    return rn32(f(q) + f(e) * f(inv_b))


def div_rn_by_np(a, b, inv_b):
    """div_rn_by over an array of float32 numerators, exactly: a inv_b and
    q b are products of 24-bit significands (exact in float64), a - q b
    spans under 53 bits (exact), e inv_b is exact, and q + e inv_b is held
    as a float64 sum and its exact error (two-sum), which decides the
    rounding to float32 only where the sum lies on a float32 midpoint."""
    a64, b64, y64 = (np.asarray(a, np.float32).astype(np.float64),
                     np.float64(b), np.float64(inv_b))
    q = (a64 * y64).astype(np.float32).astype(np.float64)
    e = (a64 - q * b64).astype(np.float32).astype(np.float64)
    t = e * y64
    s = q + t
    bb = s - q
    err = (q - (s - bb)) + (t - bb)
    x = np.ldexp(np.frexp(s)[0], 25)           # 25 bits: a midpoint is odd
    mid = (x == np.floor(x)) & (np.mod(x, 2) == 1)
    s = np.where(mid & (err > 0), np.nextafter(s, np.inf), s)
    s = np.where(mid & (err < 0), np.nextafter(s, -np.inf), s)
    return s.astype(np.float32)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _bench_divisors():
    """{name: (divisor, numerators)}: the divisors the kernels share across
    rays on the bench scene, each with 3000 numerators of its own range
    (from the scene where it gives them, else uniform over the range)."""
    from photon_tpu_torch.models.render import RenderParams
    from photon_tpu_torch.models.render_fast import fan_scalars
    from photon_tpu_torch.models.scenes import bos_source
    from photon_tpu_torch.ops.march_dense import march_geometry
    from photon_tpu_torch.volume import build_density_volume
    cs = _chip_smoke()
    cfg, setup, rho, spacings, origin = cs.bench_scene()
    source, _, _ = bos_source(cfg, setup, np.random.default_rng(cfg.seed))
    params = RenderParams.from_setup(cfg, setup, source)
    rng = np.random.default_rng(6)
    n = 3000
    out = {}
    # the fan: -(x_lens - x0) / (image_distance - z0), over the particles
    zs = np.unique(np.asarray(source.z, np.float32))
    denoms = np.float32(params.image_distance) - zs
    pick = rng.integers(0, source.num_particles, n)
    cone = params.ray_cone_pitch_ratio * params.lens_pitch
    r1, r2 = rng.random(n), rng.random(n)
    x_lens = np.float32(cone * r1 * np.cos(2 * np.pi * r2))
    num = -(x_lens - np.asarray(source.x, np.float32)[pick])
    for i, d in enumerate(denoms):
        out[f"image distance - z0 ({i})"] = (d, num)
    # the thin lens: -hx / focal_length over the lens aperture
    st = setup.elements
    sc = fan_scalars(params, (
        float(setup.z_lens), float(st.pitch[0]),
        float(st.vertex_distance[0]), float(st.front_surface_radius[0]),
        float(st.back_surface_radius[0]), float(st.refractive_index[0]),
        float(st.transmission_ratio[0])))
    out["focal length"] = (
        np.float32(sc.focal_length),
        np.float32(rng.uniform(-0.5, 0.5, n) * sc.pitch))
    # the sensor: (ix - pixel_1_x) / pixel_pitch over the sensor's width
    pp = np.float32(params.pixel_pitch)
    width = np.float32(cfg.camera_design.x_pixel_number) * pp
    out["pixel pitch"] = (pp, np.float32(rng.uniform(-0.1, 1.1, n)) * width)
    # the march, 64^3 and 512^3: (x - min_x) / sx, (z_at - z_plane) / dz
    vol64 = build_density_volume(rho, spacings, origin, device="cpu")
    vol512, _ = cs.bench_volume_512(setup, torch.device("meta"), 512)
    for label, vol in (("64^3", vol64), ("512^3", vol512)):
        g = march_geometry(vol)
        w = int(vol.sizes[0])
        for nm, s in (("sx", g.sx), ("sy", g.sy)):
            out[f"{nm}, {label}"] = (
                s, np.float32(rng.uniform(-2.0, w + 1.0, n)) * s)
        out[f"dz_slab, {label}"] = (
            g.dz_slab, np.float32(rng.uniform(0.0, 1.0, n)) * g.dz_slab)
    return out


_DIVISORS = None


def bench_divisors():
    global _DIVISORS
    if _DIVISORS is None:
        _DIVISORS = _bench_divisors()
    return _DIVISORS


# every divisor of the bench scene: its 120,000 particles lie in one plane,
# so "image distance - z0" takes one value
DIVISORS = ["image distance - z0 (0)", "focal length", "pixel pitch",
            "sx, 64^3", "sy, 64^3", "dz_slab, 64^3", "sx, 512^3", "sy, 512^3",
            "dz_slab, 512^3"]


def test_the_bench_has_no_other_divisor():
    assert sorted(bench_divisors()) == sorted(DIVISORS)


@pytest.mark.parametrize("name", DIVISORS)
def test_reciprocal_division_returns_the_ieee_quotient(name):
    b, nums = bench_divisors()[name]
    b = np.float32(b)
    inv_b = np.float32(f32_reciprocal(b))
    rng = np.random.default_rng(7)
    # beside the divisor's own numerators: zero and the whole exponent range
    wide = np.float32(rng.standard_normal(200)
                      * 10.0 ** rng.uniform(-30, 30, 200))
    nums = np.concatenate([np.asarray(nums, np.float32), wide,
                           np.float32([0.0, 1.0, -1.0, b, -b])])
    assert nums.size >= 3000
    for a in nums:
        want = np.float32(a) / b
        assert rn32(f(a) / f(b)) == want          # the emulation's rounding
        got = div_rn_by(a, b, inv_b)
        assert got == want and np.signbit(got) == np.signbit(want) \
            or (got == 0 and want == 0), (a, b, got, want)


def test_the_reciprocal_is_the_correctly_rounded_one():
    """f32_reciprocal gives RN(1 / float32(x)): the float32 nearest to the
    exact reciprocal, which the correction needs; and what host C++ forms
    for the march (1.0f / x in make_geom) is the same IEEE quotient."""
    for name, (b, _) in bench_divisors().items():
        b = np.float32(b)
        r = np.float32(f32_reciprocal(b))
        assert r == rn32(1 / f(b)), name
        assert r == np.float32(1.0) / b, name


@pytest.mark.parametrize("name", DIVISORS)
def test_reciprocal_division_is_exact_for_every_numerator_significand(name):
    """All 2^23 numerators in [1, 2) against numpy's IEEE float32 division.
    A power of two scales numerator, quotient and remainder exactly, and a
    sign flips them, so this covers every numerator whose quotient and
    remainder stay normal numbers.  The first product alone is not always
    within an ulp of the quotient (the premise of Markstein's theorem), so
    the divisors are swept, not argued."""
    b = np.float32(bench_divisors()[name][0])
    inv_b = np.float32(f32_reciprocal(b))
    rng = np.random.default_rng(8)
    check = np.float32(rng.uniform(1.0, 2.0, 400))   # the emulations agree
    assert np.array_equal(div_rn_by_np(check, b, inv_b).view(np.uint32),
                          np.array([div_rn_by(a, b, inv_b) for a in check],
                                   np.float32).view(np.uint32))
    wrong = 0
    for lo in range(1 << 23, 1 << 24, 1 << 20):
        a = np.ldexp(np.arange(lo, lo + (1 << 20), dtype=np.float64),
                     -23).astype(np.float32)
        got = div_rn_by_np(a, b, inv_b)
        wrong += int((got.view(np.uint32) != (a / b).view(np.uint32)).sum())
    assert wrong == 0
