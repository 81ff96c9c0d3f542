"""The cubic cell ``bos512_cubic_invert``: its configuration beside the
others, its reference loading nothing of the program, its driver end to
end on the CPU at a small size (sound, faulty, the control, a solve that
marches trilinear), and its readers on synthetic readings."""
import copy
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.control import readings
from benchmark.core import spans as SP
from benchmark.core import spec as S
from benchmark.core import trace as T
from benchmark.counts.common import bound_ms
from benchmark.tests import tiny
from benchmark.tests.test_bench_faults import (half_batch_invert, patched,
                                                unchanged_state)
from benchmark.tests.test_bench_spans import Ev, kernel, launch, reading

SPEC = S.load_spec()
CELL = "bos512_cubic_invert"
CPU = torch.device("cpu")


def docs():
    """The cell's configuration and traffic at the size of
    ``tiny.bos()``."""
    doc = tiny.bos()
    doc["simulation"]["density_gradients"]["interpolation_scheme"] = 2
    return doc, tiny.traffic("invert_solves_cubic", steps=5, warm_steps=1)


def test_the_cubic_config_shares_source_and_reduced_with_no_other():
    """A configuration is told apart from the others by its ``source`` and
    ``reduced``: the cubic one takes the source of its scheme.  (The first
    two configurations share the paper's source and an empty ``reduced``
    with each other.)"""
    key = {c["name"]: (c["source"], tuple(c["reduced"]))
           for c in SPEC["configs"]}
    cubic = key.pop("bos_bench_512_cubic")
    assert cubic not in key.values()
    assert cubic[0].startswith("https://github.com/lalitkrajendran/photon ")


def test_the_cubic_config_is_the_bench_scene_under_scheme_2():
    cubic = S.config_doc(SPEC, "bos_bench_512_cubic")
    bench = copy.deepcopy(S.config_doc(SPEC, "bos_bench_512"))
    assert cubic["simulation"]["density_gradients"][
        "interpolation_scheme"] == 2
    bench["simulation"]["density_gradients"]["interpolation_scheme"] = 2
    assert cubic["simulation"] == bench["simulation"]
    assert cubic["volume"] == bench["volume"]
    entry = next(c for c in SPEC["configs"]
                 if c["name"] == "bos_bench_512_cubic")
    assert cubic["source"] == entry["source"]
    assert cubic["reduced"] == entry["reduced"] == []


def test_cubic_reference_loads_nothing_of_the_program():
    code = ("import sys, torch\n"
            "import benchmark.reference.cubic\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('photon_tpu_torch', 'jax',\n"
            "                                    'photon_tpu')))\n"
            "print(torch.backends.cuda.matmul.allow_tf32,\n"
            "      torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "False False"]


@pytest.mark.parametrize("fault", [None, unchanged_state, half_batch_invert],
                         ids=["sound", "unchanged_state", "half_batch"])
def test_the_cubic_cell_on_the_cpu(fault):
    res = run.run_cell(SPEC, CELL, 2 ** 31 + 5, 1.0, False, CPU,
                       time.perf_counter(), fault=fault, docs=docs())
    assert res["correct"] is (fault is None), res["checks"]


def test_the_trilinear_march_is_not_the_cubic_cell():
    """The same cell with the configuration's scheme 1: the program
    inverts through the trilinear march, and the cubic reference finds
    it."""
    doc, traffic = docs()
    doc["simulation"]["density_gradients"]["interpolation_scheme"] = 1
    res = run.run_cell(SPEC, CELL, 2 ** 31 + 5, 1.0, False, CPU,
                       time.perf_counter(), docs=(doc, traffic))
    assert res["correct"] is False, res["checks"]


def test_the_control_fails_a_limit():
    r = readings(SPEC, CELL, 2 ** 31 + 9, 1.0, CPU, docs=docs())
    lim = r["limits"]
    assert all(r["program"][k] <= lim[k] for k in lim), r
    assert any(r["control"][k] > lim[k] for k in lim), r


class _ScaledBackward(torch.autograd.Function):
    """The identity forward; the backward scaled by ``GRAD_SCALE``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return GRAD_SCALE * g


GRAD_SCALE = 1.05


def scaled_prefilter_backward(prefilter):
    """The prefilter's backward (K12 on the card; on the CPU autograd
    through the plain prefilter, which the march takes from
    ``march_dense``) scaling the field's cotangent by 5%: the images, and
    Adam's steps, stay as they were."""
    def fn(field):
        return prefilter(_ScaledBackward.apply(field))
    return fn


def test_a_scaled_gradient_comes_out_not_correct():
    """Adam ignores the gradient's scale, so only ``grad_gap`` sees it."""
    with patched("photon_tpu_torch.ops.march_dense",
                 "bspline_prefilter_plain", scaled_prefilter_backward):
        res = run.run_cell(SPEC, CELL, 2 ** 31 + 5, 1.0, False, CPU,
                           time.perf_counter(), docs=docs())
    checks = res["checks"]
    assert res["correct"] is False, checks
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]
    for k in ("loss_gap", "change_gap", "volume_gap"):
        assert checks[k]["value"] <= checks[k]["limit"], checks


def trilinear_render(render):
    """The render as a solve that takes no scheme calls it: under
    ``render_image_fast``'s default, trilinear."""
    def fn(*a, interpolation_scheme=1, **kw):
        return render(*a, **kw)
    return fn


def test_a_solve_that_marches_trilinear_is_refused_in_setup():
    """Set-up's check: the solve's first loss is not the cubic render's,
    so the driver raises before its window."""
    dmod = S.module("drivers", "invert_bos_cubic")
    with patched("photon_tpu_torch.inverse", "render_image_fast",
                 trilinear_render):
        with pytest.raises(RuntimeError, match="interpolation_scheme 2"):
            dmod.Driver(*docs(), 3, CPU)
    drv = dmod.Driver(*docs(), 3, CPU)
    assert drv.scheme_gap() <= dmod.SCHEME_GAP


def test_bounds_at_the_bench_shapes():
    # K11 and K12 a launch: a third of the 2.15 GB field read and written,
    # 1.282 ms a call in all (PERF.md's row 13)
    for k in ("prefilter", "prefilter_bwd"):
        cm = S.module("counts", k)
        ms, by = bound_ms(*reversed(cm.work(dict(voxels=512 ** 3,
                                                 channels=4))))
        assert by == "bytes" and 3 * ms == pytest.approx(1.282, abs=5e-4)
    cm = S.module("counts", "march_bwd_cubic")
    P = 120_000
    ms, by = bound_ms(*reversed(cm.work(dict(
        rays=P, steps=P * 511, touched=4_000_000, field_voxels=512 ** 3))))
    assert by == "operations" and 5.0 < ms < 6.0


def prefilter_events():
    """One step: K11 inside ``prefilter.coefficients`` inside the render,
    K12 inside ``prefilter.transpose`` inside the backward (launched from
    autograd's thread), K4 beside it."""
    return [
        Ev("invert.step", 0, 100), Ev("invert.render", 5, 20),
        Ev("render.chief_march", 6, 15),
        Ev("prefilter.coefficients", 7, 6),
        Ev("invert.backward", 30, 40), Ev("prefilter.transpose", 50, 10),
        launch(8, 1), kernel("prefilter_tile_kernel", 9, 3, 1),
        launch(10, 2), kernel("prefilter_tile_kernel", 12, 3, 2),
        launch(11, 3), kernel("prefilter_tile_kernel", 15, 3, 3),
        launch(14, 4), kernel("march_dense_kernel", 18, 4, 4),
        launch(35, 5, thread=2),
        kernel("march_bwd_stage_kernel<2>", 36, 10, 5),
        launch(51, 6, thread=2), kernel("prefilter_tile_bwd_kernel", 52, 5, 6),
        launch(52, 7, thread=2), kernel("prefilter_tile_bwd_kernel", 57, 5, 7),
        launch(53, 8, thread=2), kernel("prefilter_tile_bwd_kernel", 62, 5, 8),
    ]


def test_the_prefilter_spans_are_read(monkeypatch):
    counts = S.module("counts", "prefilter")    # as a traced window does
    assert "prefilter." in SP.PREFIXES
    monkeypatch.setattr(SP, "PREFIXES", tuple(
        p for p in SP.PREFIXES if p != "prefilter."))
    sr_without = SP.from_events(prefilter_events(), 5_000_000, (0.0, 1.0))
    counts.read_spans()
    assert SP.PREFIXES.count("prefilter.") == 1
    sr = SP.from_events(prefilter_events(), 5_000_000, (0.0, 1.0))
    assert sr.device_s("prefilter.coefficients") == pytest.approx(9e-6)
    assert sr.device_s("prefilter.transpose") == pytest.approx(15e-6)
    assert sr.device_s("render.chief_march") == pytest.approx(4e-6)
    read = S.module("metrics", "prefilter_ms.cubic").read
    assert read(reading(sr, units=1)) == pytest.approx(24e-3)
    # a program without the spans, or steps the spans do not match
    assert read(reading(sr_without, units=1)) is None
    assert read(reading(sr, units=2)) is None
    assert read(reading(None, units=1)) is None


def test_rooflines_held_to_kernel_launches():
    """Each kernel's share, held to its counter: three launches of K11 and
    of K12 a call; a counter that counts calls leaves the share out."""
    class Key:
        def __init__(self, key, count, us):
            self.key, self.count, self.self_device_time_total = key, count, us

    shape = dict(voxels=512 ** 3, channels=4)
    events = [Key("prefilter_tile_kernel(float const*, float*)", 3, 4470.0),
              Key("prefilter_tile_bwd_kernel(float const*, float*)", 3,
                  4560.0),
              Key("void march_bwd_stage_kernel<2>(float const*)", 1, 1.5e5)]

    def at(counters):
        return T.Reading(
            key_events=events, busy_s=1.0, window_s=1.0, requests=1,
            units=1, counters=counters, phases={},
            shapes={"prefilter": shape, "prefilter_bwd": shape,
                    "march_bwd_cubic": dict(rays=120_000,
                                            steps=120_000 * 511,
                                            touched=4_000_000,
                                            field_voxels=512 ** 3)})

    r = at({"launch_prefilter": 3, "launch_prefilter_bwd": 3,
            "march_backward_stage": 1})

    def metric(name, r):
        return S.module("metrics", name).read(r)

    assert metric("prefilter_roofline_pct.cubic", r) == pytest.approx(
        100 * 1.282 / 4.47, rel=1e-3)
    assert metric("prefilter_bwd_roofline_pct.cubic", r) == pytest.approx(
        100 * 1.282 / 4.56, rel=1e-3)
    assert 3.0 < metric("march_bwd_roofline_pct.cubic", r) < 4.0
    calls = at({"launch_prefilter": 1, "launch_prefilter_bwd": 1,
                "march_backward_stage": 1})
    assert metric("prefilter_roofline_pct.cubic", calls) is None
    assert metric("prefilter_bwd_roofline_pct.cubic", calls) is None
