"""The kernels' counts against the figures ``chip_smoke.py`` printed at the
bench's shapes (PERF.md's table of kernels)."""
import pytest

from benchmark.core import spec as S
from benchmark.counts.common import bound_ms

P, R = 120_000, 500


def bound(kernel, **shape):
    return bound_ms(*reversed(S.module("counts", kernel).work(shape)))


@pytest.mark.parametrize("kernel,shape,want,by", [
    ("fan_fwd", dict(particles=2000, rays=R, march=True, lens="general"),
     0.0034, "operations"),
    ("fan_fwd", dict(particles=P, rays=R, march=True, lens="general"),
     0.2015, "operations"),
    ("fan_bwd", dict(particles=P, rays=R, march=True, lens="general"),
     0.6090, "operations"),
    ("gradient", dict(voxels=512 ** 3), 0.801, "bytes"),
])
def test_bounds_at_bench_shapes(kernel, shape, want, by):
    ms, which = bound(kernel, **shape)
    assert which == by
    # as printed: to the last digit shown
    assert ms == pytest.approx(want, abs=5e-5 if want < 0.01 else 5e-4)


def test_march_bounds_at_bench_512():
    # chip_smoke phase 2j, the bench's 120,000 rays through 512^3: every
    # ray crosses the 511 slabs and touches 2,612,160 voxels
    steps, touched = P * 511, 2_612_160
    k1, by1 = bound("march_fwd", rays=P, steps=steps, touched=touched,
                    residual=False)
    k4, by4 = bound("march_bwd", rays=P, steps=steps, touched=touched,
                    field_voxels=512 ** 3)
    assert by1 == "operations" and k1 == pytest.approx(0.426, rel=5e-3)
    assert by4 == "bytes" and k4 == pytest.approx(2.121, rel=5e-3)


def test_march_counts_of_straight_rays():
    import torch
    from benchmark.counts.march_common import in_band_steps, touched_voxels
    from benchmark.reference.render import geometry
    g = geometry((8, 8, 6), [1.0, 1.0, 1.0], [0.0, 0.0, 750e3 - 10.0], 0.0)
    rays = [torch.tensor([3.2]), torch.tensor([4.1]),
            torch.tensor([g.z_max + 5.0]), torch.tensor([0.0]),
            torch.tensor([0.0]), torch.tensor([-1.0])]
    assert in_band_steps(g, rays) == 5
    # a vertical ray keeps one 2 x 2 footprint through all six planes
    assert touched_voxels(g, rays) == 4 * 6
